"""Slider serving: a warm sampler behind a small HTTP API
(port of the batch-boundary engine of sliders_tpu/serving/server.py).

  - The scale sweep IS the batch dimension: a request for k scales runs one
    batched denoise, padded up to a bucket size (1, 2, 4, 8, 16 by default).
  - One worker thread owns the device and drains a request queue. Queued
    requests whose adapters share one structure signature — including
    DIFFERENT sliders — coalesce into one denoise: scales, start_noise and
    guidance ride as per-row vectors, the adapters stack per row
    (lora/batch.py; also a lone adapter, where the JAX engine passes its
    solo tree), and the rows split back per request afterwards.
    Padding rows reuse request 0's start_noise, guidance, conditioning and
    latent, at scale 0.
  - Initial latents come from a torch.Generator seeded with the request
    seed, so a request's image does not depend on its co-riders.
  - `scheduler` is ddim (the default), ddpm, lms or euler_a. The ancestral
    samplers (ddpm, euler_a) draw one noise tensor per step for the whole
    batch, from the request's generator after its latents, so coalescing is
    OFF for them: a request's image must not depend on concurrent traffic.
  - SDXL (`models.is_xl`, the "xl" family) serves through the same engine:
    each row carries its pooled text embeds and time ids beside its prompt
    embeddings, and the guided noise is rescaled at 0.7.
  - The f32 VAE decode takes `decode_rows` rows at a time (8 M output
    pixels: 8 rows at 1024 px), which bounds its peak memory.

`FluxSliderEngine` serves FLUX sliders over the same queue and batching:
no CFG doubling, the slider gate is the step-index `skip_till` riding in
the start_noise slot, and coalescing is always on (the FlowMatch sampler is
deterministic).

Endpoints (JSON in, JSON out; images as base64 PNG):
  GET  /healthz    -> {ok, family, is_xl, image_size, steps, sliders, stats}
  POST /sliders    -> {name, path} or {name, compose: [{path | name, scale}]}
  POST /generate   -> {prompt, seed?, slider?, scales?, start_noise? (FLUX:
                       skip_till?), negative_prompt?, guidance_scale?}
                   -> {images: [{scale, png: b64}, ...], latency_ms}

`load_composition` (and the compose form of POST /sliders) registers the
rank concatenation of several sliders at their scales (lora/compose.py),
served at slider scale 1 as one adapter.

`SliderEngine(continuous=True)` (SD and SDXL) keeps one fixed row bucket
in flight and advances it `chunk_steps` denoise steps a device call
(`text2image.make_continuous_step_fn`): every row has its own step
position, requests JOIN mid-flight at chunk boundaries (their rows written
into free slots, their LMS history columns zeroed) and EXIT when their
steps are done (the done rows gathered, padded to a power of two and
decoded). A row computes what the boundary engine computes for it at the
same bucket (both engines stack every adapter per row), so on the CPU a
request's PNGs are the boundary engine's at bucket `continuous_rows`, byte
for byte, joiners included (tests/test_torch_continuous.py). On the H100
that holds for a request that starts a batch, whose rows hold the slots of
its boundary run. A joiner's rows hold other slots, where cuDNN's bf16 3x3
convs at the UNet's 32^2, 16^2 and 8^2 levels round a row by its position
in the batch, and its exit decode runs at its power-of-two row count: its
PNGs stay within 40 dB PSNR of the boundary run's (44.5-46.8 dB measured;
chip_smoke.py; ROADMAP queue 3). Where the JAX engine's continuous worker
is not followed (ROADMAP queue 3):
  - starvation: a queue head that cannot join the live batch (signature,
    rank bucket or free rows) waits at most ceil(steps / chunk_steps)
    chunks; after that nothing else is admitted until it fits, at the
    latest when the batch drains;
  - error scope: a joining request whose host inputs fail (prompt encode,
    adapter stacking, rank padding) fails alone; the batch-wide reset is
    for failures of the chunk and decode device calls;
  - the warm-up's join holds the device lock while it queues its two
    requests, so the second really joins a live batch (`stats["joins"]`).

Not ported yet: dp and pp meshes (ROADMAP queue 1, item 15).

Run it: python -m sliders_tpu_torch.cli.serve --base <snapshot> [--flux] [--port N]
"""

from __future__ import annotations

import base64
import json
import struct
import threading
import time
import zlib
from typing import Optional

import numpy as np
import torch

from sliders_tpu_torch.diffusion.schedulers import (make_flowmatch_sampler, make_sampler,
                                                    make_schedule)
from sliders_tpu_torch.lora import io as lora_io
from sliders_tpu_torch.lora.batch import _rank_axes, stack_sliders, structure_signature
from sliders_tpu_torch.lora.compose import compose_sliders
from sliders_tpu_torch.models import flux
from sliders_tpu_torch.models.params import tree_to
from sliders_tpu_torch.ops.basic import SliderLora
from sliders_tpu_torch.pipelines import flux_t2i
from sliders_tpu_torch.pipelines import text2image as t2i

_SCALE_BUCKETS = (1, 2, 4, 8, 16)
# output pixels per VAE decode call: 8 images at 1024 px, whose f32 decode
# took a bf16 FLUX-dev engine to a 68.3 GB peak on an 80 GB H100
# (chip_smoke.py); larger buckets and canvases decode in slices of the bucket
_DECODE_PIXELS = 8 * 1024 * 1024


def decode_rows_for(image_size: int) -> int:
    """Rows per VAE decode call at `image_size` px (8 at 1024 px, 32 at
    512), which bounds the f32 decode's peak memory."""
    return max(1, _DECODE_PIXELS // image_size ** 2)


def _bucket(n: int, buckets=_SCALE_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"at most {buckets[-1]} scales per request, got {n}")


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, no filtering), stdlib only."""
    h, w, c = img.shape
    if c != 3 or img.dtype != np.uint8:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got {img.shape} {img.dtype}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def _serving_device(device, models) -> torch.device:
    if models.vae_params is None:
        raise ValueError("serving needs the VAE (load with load_vae=True)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    return device


class _Pending:
    """One queued /generate request awaiting the batching worker."""

    __slots__ = (
        "prompt", "negative", "seed", "scales", "slider", "weights", "sig",
        "start_noise", "guidance", "event", "result", "error", "waited", "slider_id",
    )

    def __init__(self, prompt, negative, seed, scales, slider, weights, sig,
                 start_noise, guidance):
        self.prompt = prompt
        self.negative = negative
        self.seed = seed
        self.scales = scales
        self.slider = slider
        self.weights = weights
        self.sig = sig
        self.start_noise = start_noise
        self.guidance = guidance
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.waited = 0  # continuous engine: chunks run while this request sat queued
        self.slider_id = None  # a pipeline's registration id of `weights`


class SliderEngine:
    """Owns the models on one device, the registry of loaded sliders, and the
    batching worker. Thread-safe: all device work happens in the worker."""

    def __init__(
        self,
        models,
        *,
        device="cuda",
        scheduler: str = "ddim",
        steps: int = 50,
        image_size: int = 512,
        guidance_scale: float = 7.5,
        start_noise: float = 750.0,
        compute_dtype=torch.bfloat16,
        buckets=None,
        mesh=None,
        continuous: bool = False,
        continuous_rows: Optional[int] = None,
        chunk_steps: int = 5,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "multi-device (dp mesh) serving is not ported yet (ROADMAP queue 1, item 15)")
        self.device = _serving_device(device, models)
        models.unet_params = tree_to(models.unet_params, self.device)
        models.vae_params = tree_to(models.vae_params, self.device)
        for te in models.text_encoders:
            te.params = tree_to(te.params, self.device)
        self.models = models
        self.family = "xl" if models.is_xl else "sd"
        self.image_size = int(image_size)
        self.steps = int(steps)
        self.default_guidance = float(guidance_scale)
        self.default_start_noise = float(start_noise)
        self.dtype = compute_dtype
        self.sampler = make_sampler(make_schedule(), scheduler, num_steps=self.steps)
        rescale = 0.7 if models.is_xl else 0.0
        self.fn = t2i.make_sampling_fn(models.unet_config, self.sampler,
                                       guidance_rescale=rescale, compute_dtype=self.dtype)
        if continuous:  # raises for the stochastic samplers
            self._cont_fn = t2i.make_continuous_step_fn(
                models.unet_config, self.sampler, chunk=int(chunk_steps),
                guidance_rescale=rescale, compute_dtype=self.dtype)
        self._init_runtime(buckets, coalesce=not self.sampler.stochastic, continuous=continuous,
                           continuous_rows=continuous_rows, chunk_steps=chunk_steps)

    def _init_runtime(self, buckets, coalesce: bool = True, continuous: bool = False,
                      continuous_rows: Optional[int] = None, chunk_steps: int = 5) -> None:
        """The registry, the prompt cache, the queue, the decode slice and
        the batching worker; `coalesce` lets the worker put several queued
        requests in one denoise; `continuous` starts the continuous worker
        on a bucket of `continuous_rows` rows (default: the largest bucket;
        the buckets are cut to it) and `chunk_steps` steps a call."""
        self.decode_rows = decode_rows_for(self.image_size)
        self._buckets = _SCALE_BUCKETS
        if buckets is not None:
            buckets = tuple(int(b) for b in buckets)
            if not buckets or any(b < 1 for b in buckets):
                raise ValueError(f"buckets must be non-empty positive ints, got {buckets}")
            self._buckets = tuple(sorted(buckets))
        self.sliders: dict[str, dict] = {}
        self._registry_lock = threading.RLock()
        # held by the worker around its device work; a caller that holds it
        # knows the worker is not between two of its calls
        self._lock = threading.Lock()
        # (prompt, negative) -> encoded conditioning; FIFO-capped
        self._embed_cache: dict[tuple, tuple] = {}
        self._embed_cache_cap = 32
        self._coalesce = coalesce
        self._queue: list = []
        self._queue_cv = threading.Condition()
        self._closed = False
        self.request_timeout = 3600.0
        self.stats = {"requests": 0, "batches": 0, "rows": 0}
        self._continuous = bool(continuous)
        target = self._worker_loop
        if self._continuous:
            if not coalesce:
                raise ValueError("continuous batching requires a deterministic sampler "
                                 "(coalescing is off for ddpm and euler_a)")
            self._cont_rows = int(continuous_rows if continuous_rows is not None
                                  else self._buckets[-1])
            # every request must fit the fixed row budget or it is never served
            self._buckets = tuple(b for b in self._buckets if b <= self._cont_rows)
            if not self._buckets:
                raise ValueError(f"continuous_rows={self._cont_rows} is below the smallest "
                                 f"scale bucket")
            self._cont_chunk = int(chunk_steps)
            if not 1 <= self._cont_chunk <= self.steps:
                raise ValueError(f"chunk_steps={chunk_steps} must be in [1, {self.steps}]")
            # a queue head that cannot join waits this many chunks, one
            # whole denoise, before admission closes behind it
            self._cont_patience = -(-self.steps // self._cont_chunk)
            self._cont_sig = self._cont_buckets = None  # the live batch's class
            self.stats.update(chunks=0, joins=0)
            target = self._continuous_worker_loop
        self._worker = threading.Thread(target=target, daemon=True)
        self._worker.start()

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop the batching worker after the queued requests (idempotent);
        new generate() calls are rejected."""
        with self._queue_cv:
            if not self._closed:
                self._closed = True
                self._queue.append(None)  # sentinel: worker exits after drain
                self._queue_cv.notify()
        self._worker.join(timeout)

    # -- registry ---------------------------------------------------------

    def register_slider(self, name: str, weights: dict) -> None:
        """Register an in-memory adapter tree (moved to the engine's device)."""
        weights = tree_to(weights, self.device)
        with self._registry_lock:
            self.sliders[name] = weights

    def _lora_base(self) -> dict:
        """The parameters whose module paths a slider file's names resolve to."""
        return self.models.unet_params

    def load_slider(self, name: str, path: str) -> None:
        self.register_slider(name, lora_io.load_slider(path, self._lora_base()))

    def load_composition(self, name: str, parts: list) -> None:
        """Register under `name` the composition of `parts`, each
        {"path": <checkpoint>} or {"name": <loaded slider>} with an optional
        "scale" (default 1)."""
        adapters = []
        for part in parts:
            if not isinstance(part, dict) or not ({"name", "path"} & set(part)):
                raise ValueError(f"compose part needs 'name' or 'path': {part!r}")
            if "name" in part:
                with self._registry_lock:
                    if part["name"] not in self.sliders:
                        raise KeyError(f"slider {part['name']!r} not loaded")
                    w = self.sliders[part["name"]]
            else:
                w = lora_io.load_slider(part["path"], self._lora_base())
            adapters.append((tree_to(w, self.device), float(part.get("scale", 1.0))))
        self.register_slider(name, compose_sliders(adapters))

    # -- generation -------------------------------------------------------

    def _encode(self, prompt: str, negative: str):
        """Cached encode_conditioning; called from the worker thread only."""
        key = (prompt, negative)
        hit = self._embed_cache.get(key)
        if hit is None:
            hit = t2i.encode_conditioning(self.models, prompt, negative, self.image_size)
            if len(self._embed_cache) >= self._embed_cache_cap:
                self._embed_cache.pop(next(iter(self._embed_cache)))
            self._embed_cache[key] = hit
        return hit

    def _make_pending(self, prompt: str, *, seed: int = 0, slider: Optional[str] = None,
                      scales: Optional[list] = None, start_noise: Optional[float] = None,
                      negative_prompt: str = "",
                      guidance_scale: Optional[float] = None) -> _Pending:
        """Validate a request and resolve its slider in the CALLER's thread."""
        scales = [float(s) for s in (scales if scales is not None else [0.0])]
        _bucket(len(scales), self._buckets)
        weights, sig = None, None
        if slider is not None:
            with self._registry_lock:
                if slider not in self.sliders:
                    raise KeyError(f"slider {slider!r} not loaded")
                weights = self.sliders[slider]
            sig = structure_signature(weights)
        return _Pending(
            str(prompt), str(negative_prompt), int(seed), scales, slider, weights, sig,
            self.default_start_noise if start_noise is None else float(start_noise),
            self.default_guidance if guidance_scale is None else float(guidance_scale),
        )

    def _submit(self, pendings: list) -> None:
        with self._queue_cv:
            if self._closed:
                raise RuntimeError("engine is closed")
            self._queue.extend(pendings)
            self._queue_cv.notify()

    def _wait(self, p: _Pending) -> list:
        if not p.event.wait(timeout=self.request_timeout):
            raise TimeoutError(f"request not served within {self.request_timeout}s")
        if p.error is not None:
            raise p.error
        return p.result

    def generate(self, prompt: str, *, seed: int = 0, slider: Optional[str] = None,
                 scales: Optional[list] = None, start_noise: Optional[float] = None,
                 negative_prompt: str = "", guidance_scale: Optional[float] = None) -> list:
        """Returns [(scale, PNG bytes), ...] ordered like the request's scales.
        Blocks until the worker has served the request; concurrent callers
        with compatible adapters share one batched denoise."""
        p = self._make_pending(prompt, seed=seed, slider=slider, scales=scales,
                               start_noise=start_noise, negative_prompt=negative_prompt,
                               guidance_scale=guidance_scale)
        self._submit([p])
        return self._wait(p)

    # -- batching worker ---------------------------------------------------

    def _worker_loop(self):
        max_rows = self._buckets[-1]
        while True:
            with self._queue_cv:
                while not self._queue:
                    self._queue_cv.wait()
                if self._queue[0] is None:  # close() sentinel
                    return
                batch = [self._queue.pop(0)]
                rows = len(batch[0].scales)
                key = batch[0].sig
                i = 0
                while self._coalesce and i < len(self._queue):
                    q = self._queue[i]
                    if q is not None and q.sig == key and rows + len(q.scales) <= max_rows:
                        batch.append(self._queue.pop(i))
                        rows += len(q.scales)
                    else:
                        i += 1
            try:
                # BaseException too: the worker is the only device owner; if
                # it died silently every caller would hang
                try:
                    for p, r in zip(batch, self._generate_batch(batch)):
                        p.result = r
                except BaseException as e:  # surfaced in every waiting caller
                    for p in batch:
                        p.error = e
            finally:
                for p in batch:
                    p.event.set()

    def _generate_batch(self, batch: list) -> list:
        """One denoise for all requests in `batch` (same signature), rows
        split back per request as PNGs."""
        rows = [len(p.scales) for p in batch]
        total = sum(rows)
        pad_n = _bucket(total, self._buckets) - total
        per_row = [p for p, r in zip(batch, rows) for _ in range(r)] + [batch[0]] * pad_n
        scale_vec = torch.tensor([s for p in batch for s in p.scales] + [0.0] * pad_n,
                                 dtype=torch.float32)
        sn_vec = torch.tensor([p.start_noise for p in per_row], dtype=torch.float32)
        g_vec = torch.tensor([p.guidance for p in per_row], dtype=torch.float32)
        # one stacked copy of each row's adapter (pow2 rank buckets), padding
        # rows at scale 0, even with one adapter in flight: the LoRA branch
        # is then the continuous engine's per-row product, whose bits do not
        # depend on the batch's other rows (a solo tree's one product may
        # split its sums otherwise on the card)
        weights = batch[0].weights
        if weights is not None:
            weights = stack_sliders([p.weights for p in per_row], round_ranks_pow2=True)

        with self._lock:
            imgs = self._run_rows(batch, rows, pad_n, weights, scale_vec, sn_vec, g_vec)
        self.stats["requests"] += len(batch)
        self.stats["batches"] += 1
        self.stats["rows"] += total

        results, off = [], 0
        for p, r in zip(batch, rows):
            results.append([(s, encode_png(imgs[off + i])) for i, s in enumerate(p.scales)])
            off += r
        return results

    def _run_rows(self, batch, rows, pad_n, weights, scale_vec, sn_vec, g_vec) -> np.ndarray:
        """Denoise one padded row batch -> uint8 (rows, H, W, 3) on the host."""
        m = self.models
        conds, unconds, addeds, lat_parts, gens = [], [], [], [], []
        for p, r in zip(batch, rows):
            cond_b, uncond_b, added_b = t2i.tile_conditioning(*self._encode(p.prompt, p.negative),
                                                              r)
            conds.append(cond_b)
            unconds.append(uncond_b)
            addeds.append(added_b)
            gens.append(torch.Generator().manual_seed(p.seed))
            lat = t2i.initial_latents(gens[-1], 1, self.image_size, self.image_size,
                                      self.sampler.init_noise_sigma)
            lat_parts.append(lat.expand(r, -1, -1, -1))
        if pad_n:  # repeat the first row into the bucket padding
            conds.append(conds[0][:1].expand(pad_n, -1, -1))
            unconds.append(unconds[0][:1].expand(pad_n, -1, -1))
            lat_parts.append(lat_parts[0][:1].expand(pad_n, -1, -1, -1))
            if addeds[0] is not None:
                addeds.append({k: v[:1].expand(pad_n, -1) for k, v in addeds[0].items()})
        added = None if addeds[0] is None else {k: torch.cat([a[k] for a in addeds])
                                                for k in addeds[0]}
        x = self.fn(
            m.unet_params,
            torch.cat(lat_parts).to(self.device),
            torch.cat(conds),
            torch.cat(unconds),
            weights,
            scale_vec,
            sn_vec,
            g_vec,
            added,
            # the ancestral draws (ddpm, euler_a: one request a batch) go
            # on from the request's generator past its latents
            generator=gens[0] if self.sampler.stochastic else None,
        )
        if not torch.isfinite(x).all():
            raise FloatingPointError("denoised latents are not finite")
        return self._decode(x)

    def _decode(self, lat: torch.Tensor) -> np.ndarray:
        """uint8 images of the latents, `decode_rows` rows per VAE call."""
        m = self.models
        return np.concatenate([
            t2i.decode_images(m.vae_params, m.vae_config, lat[i:i + self.decode_rows]).cpu().numpy()
            for i in range(0, lat.shape[0], self.decode_rows)])

    # -- step-level continuous batching -------------------------------------
    #
    # The boundary worker admits requests only between denoises, so a
    # newcomer waits out the whole denoise in flight. The continuous worker
    # keeps ONE bucket of `_cont_rows` rows in flight and advances it
    # `_cont_chunk` steps a call: each row carries its own step position,
    # requests join at chunk boundaries and exit when their steps are done.
    # Admission needs the live batch's structure signature AND the same pow2
    # rank bucket per module, exactly (as the JAX engine: a row then runs
    # the program shape of its solo run); sliderless requests form their own
    # batches. The bucket is computed in full whatever its occupancy, so
    # this mode is for sustained overlapping traffic.

    def _cont_request_rows(self, q: _Pending) -> dict:
        """A request's device inputs: its 1-row conditioning (cond, uncond,
        added or None), its initial latent (1, h, w, 4) in the compute
        dtype, and its adapter stacked over its rows at its pow2 rank
        buckets (None without a slider): the values the boundary engine
        feeds `_run_rows`, so the trajectories match."""
        cond, uncond, added = self._encode(q.prompt, q.negative)
        lat = t2i.initial_latents(torch.Generator().manual_seed(q.seed), 1, self.image_size,
                                  self.image_size, self.sampler.init_noise_sigma)
        # its pow2 rank buckets are the live batch's (`_cont_fits`)
        w = (None if q.weights is None
             else stack_sliders([q.weights] * len(q.scales), round_ranks_pow2=True))
        return {"cond": cond, "uncond": uncond, "added": added,
                "x": lat.to(self.device).to(self.dtype), "w": w}

    @staticmethod
    def _cont_rows_of(rows: list) -> dict:
        """The row-major state leaves of `rows`, a list of (inputs, request,
        scale index) in slot order."""
        inputs = [inp for inp, _, _ in rows]
        first = inputs[0]
        out = {key: torch.cat([inp[key] for inp in inputs]) for key in ("x", "cond", "uncond")}
        out["added"] = None if first["added"] is None else {
            name: torch.cat([inp["added"][name] for inp in inputs]) for name in first["added"]}
        out["w"] = None if first["w"] is None else {
            name: {leaf: torch.cat([inp["w"][name][leaf][k:k + 1] for inp, _, k in rows])
                   for leaf in entry}
            for name, entry in first["w"].items()}
        for key, values in (("scale", [q.scales[k] for _, q, k in rows]),
                            ("sn", [q.start_noise for _, q, _ in rows]),
                            ("g", [q.guidance for _, q, _ in rows])):
            out[key] = torch.tensor(values, dtype=torch.float32, device=first["x"].device)
        return out

    def _cont_fresh_state(self, new: list) -> dict:
        """The whole bucket's state from an admission into an EMPTY batch:
        `new` is [(inputs, request, slots)]; free slots repeat the first
        row's values and never advance (their step position stays n)."""
        by_slot = {slot: (inp, q, k) for inp, q, slots in new for k, slot in enumerate(slots)}
        fill = by_slot[min(by_slot)]
        state = self._cont_rows_of([by_slot.get(j, fill) for j in range(self._cont_rows)])
        state["s"] = self.sampler.init_state(state["x"])
        return state

    def _cont_join_state(self, state: dict, new: list) -> dict:
        """Write an admission into the LIVE batch, in place: the row-major
        leaves at the joining slots, and the sampler-state columns
        (history-major: LMS's (ORDER, B, ...) derivs) of those slots zeroed."""
        rows = [(inp, q, k) for inp, q, slots in new for k in range(len(slots))]
        pos = torch.tensor([slot for _, _, slots in new for slot in slots],
                           device=state["x"].device)
        upd = self._cont_rows_of(rows)
        for key in ("x", "cond", "uncond", "scale", "sn", "g"):
            state[key][pos] = upd[key].to(state[key].dtype)
        if state["added"] is not None:
            for name, leaf in state["added"].items():
                leaf[pos] = upd["added"][name].to(leaf.dtype)
        if state["w"] is not None:
            for name, entry in state["w"].items():
                for leaf, live in entry.items():
                    live[pos] = upd["w"][name][leaf].to(live.dtype)
        for hist in state["s"].values():
            hist[:, pos] = 0
        return state

    @staticmethod
    def _cont_req_buckets(q: _Pending) -> Optional[dict]:
        """The pow2 rank bucket of each module of a request's adapter (None
        without a slider); shape arithmetic only."""
        if q.weights is None:
            return None
        return {name: 1 << (e["down"].shape[_rank_axes(e)[0]] - 1).bit_length()
                for name, e in q.weights.items()}

    def _cont_fits(self, q: _Pending, buckets: Optional[dict]) -> bool:
        """Can `q` ride a batch whose rank buckets are `buckets`? Exact
        equality (the signature is the caller's check)."""
        return self._cont_req_buckets(q) == buckets

    def _cont_admit(self, busy: bool, free: list) -> list:
        """One admission round, under the queue lock: pops and returns the
        queued requests that join now, as [(request, slots)], taking their
        slots from `free`. An empty batch takes its class (signature, rank
        buckets) from the first request admitted. Once the oldest queued
        request has waited `_cont_patience` chunks without fitting, only it
        may be admitted: the batch drains until it fits."""
        admitted = []
        head = self._queue[0] if self._queue else None
        gate = head is not None and head.waited >= self._cont_patience
        i = 0
        while i < len(self._queue):
            q = self._queue[i]
            if q is None:  # close() sentinel: what is before it drains first
                break
            if not busy and not admitted:
                self._cont_sig, self._cont_buckets = q.sig, self._cont_req_buckets(q)
            if (q.sig == self._cont_sig and len(q.scales) <= len(free)
                    and self._cont_fits(q, self._cont_buckets)):
                admitted.append((self._queue.pop(i), [free.pop(0) for _ in q.scales]))
                gate = False
            elif gate:
                break
            else:
                i += 1
        return admitted

    def _cont_decode(self, state: dict, slots: list) -> np.ndarray:
        """uint8 images of the done rows: gathered, padded to a power of two
        rows (at most the bucket) and decoded `decode_rows` rows a call."""
        n_done = len(slots)
        nb = min(1 << (n_done - 1).bit_length(), self._cont_rows)
        idx = slots + [slots[0]] * (nb - n_done)
        x = state["x"][torch.tensor(idx, device=state["x"].device)]
        if not torch.isfinite(x).all():
            raise FloatingPointError("denoised latents are not finite")
        return self._decode(x)[:n_done]

    def _continuous_worker_loop(self):
        N, C, n = self._cont_rows, self._cont_chunk, self.steps
        state: Optional[dict] = None
        slot_req: list = [None] * N  # slot -> (request, scale index)
        step_idx = np.full(N, n, np.int64)
        req_slots: dict = {}  # id(request) -> (request, [slots])

        def release(q):
            for slot in req_slots.pop(id(q))[1]:
                slot_req[slot] = None
                step_idx[slot] = n

        while True:
            with self._queue_cv:
                busy = any(s is not None for s in slot_req)
                while not self._queue and not busy:
                    self._queue_cv.wait()
                if not busy and self._queue[0] is None:
                    return  # close(): drained
                free = [j for j in range(N) if slot_req[j] is None]
                new = self._cont_admit(busy, free)
            for q, slots in new:
                req_slots[id(q)] = (q, slots)
                for k, slot in enumerate(slots):
                    slot_req[slot] = (q, k)
            try:
                with self._lock, torch.inference_mode():
                    built = []
                    for q, slots in new:
                        # a joiner's host inputs fail it alone
                        try:
                            built.append((self._cont_request_rows(q), q, slots))
                        except Exception as e:
                            release(q)
                            q.error = e
                            q.event.set()
                    if built:
                        if not busy:
                            state = self._cont_fresh_state(built)
                        else:
                            state = self._cont_join_state(state, built)
                            self.stats["joins"] += 1
                        for _, _, slots in built:
                            step_idx[slots] = 0
                    if not any(s is not None for s in slot_req):
                        continue
                    state["x"], state["s"] = self._cont_fn(
                        self.models.unet_params, state["x"], state["s"], step_idx,
                        state["cond"], state["uncond"], state["w"], state["scale"],
                        state["sn"], state["g"], state["added"])
                    self.stats["chunks"] += 1
                with self._queue_cv:
                    for q in self._queue:
                        if q is not None:
                            q.waited += 1
                occupied = np.array([s is not None for s in slot_req])
                step_idx = np.where(occupied, np.minimum(step_idx + C, n), step_idx)
                done = [j for j in range(N) if slot_req[j] is not None and step_idx[j] >= n]
                if not done:
                    continue
                with self._lock, torch.inference_mode():
                    imgs = self._cont_decode(state, done)
                    self.stats["batches"] += 1
                img_of = dict(zip(done, imgs))
                finished = {id(slot_req[j][0]): slot_req[j][0] for j in done}
                for q in finished.values():
                    slots = req_slots[id(q)][1]
                    q.result = [(q.scales[k], encode_png(img_of[slot]))
                                for k, slot in enumerate(slots)]
                    release(q)
                    self.stats["requests"] += 1
                    self.stats["rows"] += len(slots)
                    q.event.set()
            except BaseException as e:
                # a failed chunk or decode: every slotted request fails and
                # the batch resets (its latents are lost)
                failed = {id(s[0]): s[0] for s in slot_req if s is not None}
                for q in failed.values():
                    release(q)
                    q.error = e
                    q.event.set()
                state = None

    def warmup(self, with_slider: Optional[str] = None, n_scales: int = 5,
               multi_tenant: bool = False) -> None:
        """Run the hot path once before serving traffic (reference sweep size:
        5 scales -> bucket 8). `multi_tenant=True` also runs a batch of two
        coalesced requests whose trees are distinct objects once, and on the
        continuous engine a mid-flight join (`_warmup_join`)."""
        if multi_tenant and with_slider is None:
            raise ValueError("multi_tenant warmup needs with_slider")
        if multi_tenant and not self._coalesce:
            raise ValueError(f"multi_tenant warmup is meaningless with the "
                             f"{self.sampler.kind!r} sampler: it never coalesces requests, "
                             f"so no stacked batch runs")
        self.generate("warmup", seed=0, slider=with_slider, scales=[0.0] * n_scales)
        if not multi_tenant:
            return
        if self._continuous:
            self._warmup_join(with_slider)
            return
        half = max(1, n_scales // 2)
        p1 = self._make_pending("warmup", slider=with_slider, scales=[0.0] * half)
        p2 = self._make_pending("warmup", slider=with_slider,
                                scales=[0.0] * max(1, n_scales - half))
        p2.weights = dict(p2.weights)
        self._submit([p1, p2])
        for p in (p1, p2):
            self._wait(p)


    def _warmup_join(self, with_slider: Optional[str]) -> None:
        """Run the continuous engine's mid-flight join once: a request, then
        a second queued while the worker is held at its first device call,
        so it joins the first's live batch (checked by `stats["joins"]`). A
        bucket of one row or a chunk of every step has no join to run."""
        if self._cont_rows < 2 or self._cont_chunk >= self.steps:
            return
        p1, p2 = (self._make_pending("warmup", seed=seed, slider=with_slider, scales=[0.0])
                  for seed in (0, 1))
        joins = self.stats["joins"]
        deadline = time.monotonic() + self.request_timeout
        with self._lock:
            self._submit([p1])
            while True:  # until the worker has admitted p1 and waits on the lock
                with self._queue_cv:
                    if p1 not in self._queue:
                        break
                if time.monotonic() > deadline:
                    raise TimeoutError("continuous warmup: the first request was never admitted")
                time.sleep(0.001)
            self._submit([p2])
        for p in (p1, p2):
            self._wait(p)
        if self.stats["joins"] == joins:
            raise RuntimeError("continuous warmup: the second request did not join a live batch")


class FluxSliderEngine(SliderEngine):
    """FLUX slider serving over the same queue, registry and batching
    (the reference's FLUX inference surface, custom_flux_pipeline.py:694-766).
    What differs from SD:

      - no CFG doubling: `guidance_scale` is the distilled guidance
        EMBEDDING value (FLUX-dev; ignored by schnell);
      - the slider gate is the step index `skip_till` (the LoRA is on while
        step i > skip_till, :703-711), riding in the start_noise slot; the
        default -1 keeps it on; HTTP also accepts it as `skip_till`;
      - the FlowMatch sampler is deterministic, so coalescing (and per-row
        stacked adapters, lora/batch.py) is always on;
      - initial noise is drawn from a torch.Generator seeded with the
        request's seed;
      - the f32 VAE decode takes `decode_rows` rows at a time, as the SD
        engine's does (8 at 1024 px, 2 at 2048 px).

    With a `mesh` that has a pp axis (`parallel/pipeline.py`) this engine
    is stage 0 of a pipeline: it keeps only its stage's blocks
    (`flux_pp_params`) beside the encoders and the VAE, encodes, embeds,
    steps the sampler and decodes, and drives the other stages, each a
    `FluxStageFollower`, through a `StageChannel`: every registration of a
    slider (also one loaded from a file or composed) is sent to them once
    under an id of its own, each batch's per-row ids (those its requests
    captured when they were queued, so that a name registered again
    while a request waits changes no stage's rows) before its denoise,
    each transformer call's shapes and per-row multiplier, and `close`.
    A registration no name and no queued request holds any more is
    dropped by the followers with the next batch. Slider files resolve
    against the whole transformer's names (a meta-device skeleton).
    `num_microbatches` splits each forward's rows (GPipe). An error inside
    a forward ends the pipeline (`StageChannel`): the request gets it, and
    every later one a RuntimeError naming it (`failed`)."""

    def __init__(
        self,
        models,
        *,
        device="cuda",
        steps: int = 30,
        image_size: int = 512,
        guidance_scale: float = 3.5,
        skip_till: float = -1.0,
        compute_dtype=torch.bfloat16,
        mesh=None,
        buckets=None,
        num_microbatches: int = 1,
    ):
        self.mesh, self.channel = mesh, None
        if mesh is not None:
            from sliders_tpu_torch.parallel.pipeline import StageChannel, flux_pp_params

            if mesh.size("pp") == 1 or mesh.coord("pp") != 0:
                raise ValueError("FluxSliderEngine runs stage 0 of a mesh with a pp axis")
            models.transformer_params = flux_pp_params(mesh, models.transformer_params,
                                                       models.transformer_config)
            self.channel = StageChannel(mesh)
            self._slider_ids: dict[str, int] = {}  # name -> its registration's id
            self._holds: dict[int, int] = {}  # id -> the names and requests that hold it
            self._next_id = 0
            self._dropped: list = []  # ids no one holds, for the followers to drop
        self.device = _serving_device(device, models)
        models.transformer_params = tree_to(models.transformer_params, self.device)
        models.t5_params = tree_to(models.t5_params, self.device)
        models.clip.params = tree_to(models.clip.params, self.device)
        models.vae_params = tree_to(models.vae_params, self.device)
        self.models = models
        self.family = "flux"
        self.image_size = int(image_size)
        self.steps = int(steps)
        self.default_guidance = float(guidance_scale)
        self.default_start_noise = float(skip_till)  # the step-index gate
        self.dtype = compute_dtype
        self._latent_hw = self.image_size // 8
        self.sampler = make_flowmatch_sampler(num_steps=self.steps,
                                              image_seq_len=(self._latent_hw // 2) ** 2)
        self.fn = flux_t2i.make_flux_sampling_fn(models.transformer_config, self.sampler,
                                                 latent_hw=self._latent_hw,
                                                 compute_dtype=self.dtype, mesh=mesh,
                                                 num_microbatches=num_microbatches,
                                                 channel=self.channel)
        self._skeleton = None
        self._init_runtime(buckets)

    def _lora_base(self) -> dict:
        if self.mesh is None:
            return self.models.transformer_params
        if self._skeleton is None:  # every block's names; this stage holds some
            self._skeleton = flux.init_params(None, self.models.transformer_config,
                                              device="meta")
        return self._skeleton

    @property
    def failed(self) -> Optional[BaseException]:
        """The error that ended this engine's pipeline, or None."""
        return None if self.channel is None else self.channel.failed

    def register_slider(self, name: str, weights: dict) -> None:
        if self.channel is None:
            return super().register_slider(name, weights)
        weights = tree_to(weights, self.device)
        with self._registry_lock:
            sid, self._next_id = self._next_id, self._next_id + 1
        self.channel.announce(("register", sid, name, tree_to(weights, "cpu")))
        with self._registry_lock:
            old = self._slider_ids.get(name)
            self.sliders[name], self._slider_ids[name], self._holds[sid] = weights, sid, 1
            if old is not None:
                self._release(old)

    def _release(self, sid: int) -> None:
        """One holder of registration `sid` less (under the registry lock)."""
        self._holds[sid] -= 1
        if not self._holds[sid]:
            del self._holds[sid]
            self._dropped.append(sid)

    def _make_pending(self, prompt: str, **kw) -> _Pending:
        with self._registry_lock:  # the weights and their id in one step
            p = super()._make_pending(prompt, **kw)
            if self.channel is not None and p.slider is not None:
                p.slider_id = self._slider_ids[p.slider]
                self._holds[p.slider_id] += 1
        return p

    def _generate_batch(self, batch: list) -> list:
        try:
            return super()._generate_batch(batch)
        finally:
            if self.channel is not None:
                with self._registry_lock:
                    for p in batch:
                        if p.slider_id is not None:
                            self._release(p.slider_id)

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop the worker after the queued requests, then (stage 0 of a
        pipeline) the followers."""
        super().close(timeout)
        if self.channel is not None:
            self.channel.close()

    def _encode(self, prompt: str, negative: str):
        """Cached 1-row (pooled, t5_embeds); FLUX has no CFG negative, so
        `negative` is ignored. Called from the worker thread only."""
        key = (prompt, "")
        hit = self._embed_cache.get(key)
        if hit is None:
            hit = flux_t2i.encode_prompts_flux(self.models, [prompt])
            if len(self._embed_cache) >= self._embed_cache_cap:
                self._embed_cache.pop(next(iter(self._embed_cache)))
            self._embed_cache[key] = hit
        return hit

    def _run_rows(self, batch, rows, pad_n, weights, scale_vec, sn_vec, g_vec) -> np.ndarray:
        m = self.models
        pooleds, t5s, lat_parts = [], [], []
        for p, r in zip(batch, rows):
            pooled, t5e = self._encode(p.prompt, p.negative)
            pooleds.append(pooled.expand(r, -1))
            t5s.append(t5e.expand(r, -1, -1))
            lat = flux_t2i.initial_packed_latents(torch.Generator().manual_seed(p.seed), 1,
                                                  self.image_size, self.image_size,
                                                  m.vae_config.latent_channels)
            lat_parts.append(lat.expand(r, -1, -1))
        if pad_n:  # repeat the first row into the bucket padding
            pooleds.append(pooleds[0][:1].expand(pad_n, -1))
            t5s.append(t5s[0][:1].expand(pad_n, -1, -1))
            lat_parts.append(lat_parts[0][:1].expand(pad_n, -1, -1))
        if self.channel is not None:  # the followers stack the same rows
            ids = None
            if weights is not None:
                ids = [p.slider_id for p, r in zip(batch, rows) for _ in range(r)]
                ids += [batch[0].slider_id] * pad_n
            with self._registry_lock:
                dropped, self._dropped = self._dropped, []
            self.channel.announce(("batch", ids, dropped))
        x = self.fn(m.transformer_params, torch.cat(lat_parts).to(self.device),
                    torch.cat(pooleds), torch.cat(t5s), weights, scale_vec,
                    sn_vec,  # per-row skip_till
                    g_vec)
        if not torch.isfinite(x).all():
            raise FloatingPointError("denoised latents are not finite")
        return self._decode(flux.unpack_latents(x, self._latent_hw, self._latent_hw))


class FluxStageFollower:
    """A stage past 0 of a pipeline-parallel FLUX server (`parallel/
    pipeline.py`): `run()` answers stage 0's `StageChannel` until it
    closes. It holds this stage's blocks (`params`, from `flux_pp_params`
    or `pp_keep`), keeps the entries of its blocks of every registration
    by its id until stage 0 drops it, stacks each batch's per-row sliders
    as stage 0 does (`stack_sliders`, ranks rounded to powers of two) and
    runs its part of each transformer call. An error ends `run()` and so
    this process, which fails stage 0's next receive."""

    def __init__(self, params: dict, cfg: flux.FluxConfig, mesh, device=None):
        from sliders_tpu_torch.parallel.pipeline import StageChannel, stage_layers

        self.params, self.cfg, self.mesh = params, cfg, mesh
        self.device = torch.device(device) if device is not None else \
            params["proj_out"]["weight"].device
        self.channel = StageChannel(mesh)
        self._layers = stage_layers(cfg, mesh.size("pp"), mesh.coord("pp"))
        self.sliders: dict[int, dict] = {}  # registration id -> this stage's entries
        self.names: dict[int, str] = {}
        self._stacked = None
        self.stats = {"forwards": 0, "batches": 0}

    def _mine(self, module: str) -> bool:
        family, i = module.split(".")[:2]
        return family in self._layers and int(i) in self._layers[family]

    def run(self) -> None:
        from sliders_tpu_torch.parallel.pipeline import flux_apply_pp

        while True:
            msg = self.channel.listen()
            kind = msg[0]
            if kind == "close":
                return
            if kind == "register":
                _, sid, name, weights = msg
                self.sliders[sid] = tree_to({m: e for m, e in weights.items()
                                             if self._mine(m)}, self.device)
                self.names[sid] = name
            elif kind == "batch":
                _, ids, dropped = msg
                for sid in dropped:
                    del self.sliders[sid], self.names[sid]
                self._stacked = None
                if ids is not None:
                    rows = [self.sliders[i] for i in ids]
                    self._stacked = stack_sliders(rows, round_ranks_pow2=True) if rows[0] \
                        else {}
                self.stats["batches"] += 1
            elif kind == "forward":
                d = msg[1]
                B, L_img, C = d["shape"]
                meta = {"device": "meta", "dtype": d["dtype"]}
                lora = None
                if d["multiplier"] is not None:
                    lora = SliderLora(self._stacked, d["multiplier"].to(self.device))
                with torch.inference_mode():
                    flux_apply_pp(
                        self.params, self.cfg, torch.empty((B, L_img, C), **meta),
                        torch.empty((B,), **meta),
                        torch.empty((B, self.cfg.pooled_projection_dim), **meta),
                        torch.empty((B, d["txt_len"], self.cfg.joint_attention_dim), **meta),
                        d["txt_ids"], d["img_ids"], self.mesh, lora=lora,
                        num_microbatches=d["microbatches"], channel=self.channel)
                self.stats["forwards"] += 1


# -- HTTP layer -----------------------------------------------------------


def make_http_server(engine: SliderEngine, host: str = "127.0.0.1", port: int = 8000):
    """ThreadingHTTPServer over the engine (stdlib only). Handlers validate
    JSON and call the engine; device work serialises in its worker."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self):
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length) if length else b"{}"
            return json.loads(raw)

        def do_GET(self):
            if self.path != "/healthz":
                return self._send(404, {"error": f"no route {self.path}"})
            with engine._registry_lock:
                names = sorted(engine.sliders)
            self._send(200, {
                "ok": True,
                "family": engine.family,
                "is_xl": engine.family == "xl",
                "image_size": engine.image_size,
                "steps": engine.steps,
                "sliders": names,
                "stats": dict(engine.stats),
            })

        def do_POST(self):
            try:
                req = self._read_json()
            except ValueError as e:  # JSONDecodeError and bad Content-Length
                return self._send(400, {"error": f"bad json: {e}"})
            if not isinstance(req, dict):
                return self._send(400, {"error": "body must be a JSON object"})
            try:
                if self.path == "/sliders":
                    missing = ({"name"} if "compose" in req else {"name", "path"}) - set(req)
                    if missing:
                        return self._send(400, {"error": f"missing field(s): {sorted(missing)}"})
                    if "compose" in req:
                        engine.load_composition(req["name"], req["compose"])
                    else:
                        engine.load_slider(req["name"], req["path"])
                    return self._send(200, {"ok": True, "name": req["name"]})
                if self.path == "/generate":
                    if "prompt" not in req:
                        return self._send(400, {"error": "missing field(s): ['prompt']"})
                    t0 = time.perf_counter()
                    imgs = engine.generate(
                        req["prompt"],
                        seed=req.get("seed", 0),
                        slider=req.get("slider"),
                        scales=req.get("scales"),
                        # FLUX engines gate by step index; "skip_till" is
                        # that family's name for the same slot
                        start_noise=req.get("start_noise", req.get("skip_till")),
                        negative_prompt=req.get("negative_prompt", ""),
                        guidance_scale=req.get("guidance_scale"),
                    )
                    return self._send(200, {
                        "images": [{"scale": s, "png": base64.b64encode(png).decode()}
                                   for s, png in imgs],
                        "latency_ms": round((time.perf_counter() - t0) * 1e3, 1),
                    })
                return self._send(404, {"error": f"no route {self.path}"})
            except KeyError as e:  # unknown slider name
                return self._send(404, {"error": f"unknown: {e}"})
            except NotImplementedError as e:
                return self._send(501, {"error": str(e)})
            except TimeoutError as e:  # before OSError: it's a subclass
                return self._send(504, {"error": str(e)})
            except (TypeError, ValueError, OSError) as e:
                return self._send(400, {"error": str(e)})
            except Exception as e:  # never drop the connection without a reply
                return self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return ThreadingHTTPServer((host, port), Handler)
