"""The port's SDXL paths against sliders_tpu on the CPU: the text_time UNet
(with the layout pin off, on, and forced through its autograd Function), the
bigG-shaped second encoder and `encode_prompts_xl`, `get_add_time_ids`, the
per-row sampling function with added conditioning and guidance rescale, the
XL train step on JAX's draws (a dynamic-crop pair included), `load_sdxl`,
the LoRA module counts at SDXL-base's widths, and `serve --xl` and
`train_text_slider --xl` end to end on the tiny SDXL snapshot of
`tests/helpers.make_tiny_snapshot(xl=True)`.

Everything runs in f32. Tolerances are stated where they are used; they
allow f32 sums taken in another order, as in the SD1.5 parity tests.
"""

import base64
import io
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import make_tiny_snapshot

from sliders_tpu.diffusion import make_sampler as jmake_sampler
from sliders_tpu.diffusion import make_schedule as jmake_schedule
from sliders_tpu.lora import network as jnet
from sliders_tpu.models import loader as jloader
from sliders_tpu.models import unet2d as junet
from sliders_tpu.ops import basic as jbasic
from sliders_tpu.ops.basic import SliderLora as JaxSliderLora
from sliders_tpu.pipelines import encoding as jenc
from sliders_tpu.pipelines import text2image as jt2i
from sliders_tpu.training import optimizers as jopt
from sliders_tpu.training import text_slider as jts
from sliders_tpu_torch.cli import serve as tserve
from sliders_tpu_torch.cli import train_text_slider as tcli
from sliders_tpu_torch.diffusion import schedulers as tsched
from sliders_tpu_torch.lora import network as tnet
from sliders_tpu_torch.models import loader as tloader
from sliders_tpu_torch.models import unet2d as tunet
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.ops import basic as tbasic
from sliders_tpu_torch.ops import layout_pin as tlp
from sliders_tpu_torch.ops.basic import SliderLora
from sliders_tpu_torch.pipelines import encoding as tenc
from sliders_tpu_torch.pipelines import text2image as tt2i
from sliders_tpu_torch.serving.server import SliderEngine, make_http_server
from sliders_tpu_torch.training import optimizers as topt
from sliders_tpu_torch.training import text_slider as tts


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def xl_snapshot(tmp_path_factory):
    return make_tiny_snapshot(str(tmp_path_factory.mktemp("sdxl_tiny")), xl=True)


@pytest.fixture(scope="module")
def xl_models(xl_snapshot):
    return (jloader.load_sdxl(xl_snapshot, dtype=jnp.float32, load_vae=True),
            tloader.load_sdxl(xl_snapshot, dtype=torch.float32, load_vae=True))


@pytest.fixture(scope="module")
def tiny_xl():
    """TINY_XL UNet params and a noxattn rank-4 slider with nonzero up
    factors, JAX and port copies."""
    params = junet.init_params(jax.random.key(0), junet.TINY_XL)
    lora = jnet.create_slider_network(jax.random.key(1), params, rank=4, train_method="noxattn")
    rng = np.random.default_rng(1)
    lora = {k: {**v, "up": jnp.asarray(rng.standard_normal(v["up"].shape) * 0.1, jnp.float32)}
            for k, v in lora.items()}
    return params, lora, from_jax_params(_np(params)), from_jax_params(_np(lora))


@pytest.fixture
def pin_switch():
    """Both packages' layout-pin switches start and end off (xdist runs
    other tests in the same process)."""
    jbasic.set_layout_pin(False)
    tbasic.set_layout_pin(False)
    yield
    jbasic.set_layout_pin(False)
    tbasic.set_layout_pin(False)


class _PinCounter:
    """Forces the UNet's pins through `LayoutPin` on CPU tensors (where the
    gate returns x) and counts the copies of its forward and backward."""

    def __init__(self, monkeypatch):
        self.copies = 0
        ref = tlp.layout_pin_ref

        def counted(x):
            self.copies += 1
            return ref(x)

        monkeypatch.setattr(tlp, "layout_pin_ref", counted)
        monkeypatch.setattr(tunet, "layout_pin",
                            lambda x: tlp.LayoutPin.apply(x) if x.ndim == 3 else x)


def _xl_inputs(rng, batch=3):
    x = rng.standard_normal((batch, 8, 8, 4)).astype(np.float32)
    t = np.array([999.0, 500.0, 1.0][:batch], np.float32)
    ctx = rng.standard_normal((batch, 7, 32)).astype(np.float32)
    pooled = rng.standard_normal((batch, 16)).astype(np.float32)
    tid = np.array([[64, 64, 0, 0, 64, 64], [128, 96, 8, 4, 64, 64],
                    [80, 72, 3, 5, 64, 64]][:batch], np.float32)
    return x, t, ctx, {"text_embeds": pooled, "time_ids": tid}


@pytest.mark.parametrize("pin", ["off", "on", "forced"])
def test_tiny_xl_unet_matches_jax(tiny_xl, pin_switch, monkeypatch, pin):
    """TINY_XL with text_time conditioning and a per-row slider against the
    JAX UNet (whose layout pin is the identity off the TPU), within 1e-5 of
    the output's largest value. 'on' sets the switch (a no-op for CPU
    tensors); 'forced' sends the 4 transformers' 8 boundaries through
    `LayoutPin`'s copy."""
    params, lora, tparams, tlora = tiny_xl
    rng = np.random.default_rng(2)
    x, t, ctx, added = _xl_inputs(rng)
    mult = np.array([-1.0, 0.0, 2.0], np.float32)
    if pin != "off":
        jbasic.set_layout_pin(True)
        tbasic.set_layout_pin(True)
    counter = _PinCounter(monkeypatch) if pin == "forced" else None
    ref = np.asarray(junet.apply(params, junet.TINY_XL, jnp.asarray(x), jnp.asarray(t),
                                 jnp.asarray(ctx), added_cond=jax.tree.map(jnp.asarray, added),
                                 lora=JaxSliderLora(weights=lora, multiplier=jnp.asarray(mult))))
    out = tunet.apply(tparams, tunet.TINY_XL, torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(ctx),
                      added_cond={k: torch.from_numpy(v) for k, v in added.items()},
                      lora=SliderLora(weights=tlora, multiplier=torch.from_numpy(mult)))
    assert out.shape == ref.shape == (3, 8, 8, 4)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    if counter is not None:
        assert counter.copies == 8


def test_xl_unet_needs_added_cond(tiny_xl):
    _, _, tparams, _ = tiny_xl
    with pytest.raises(ValueError, match="added_cond"):
        tunet.apply(tparams, tunet.TINY_XL, torch.zeros(1, 8, 8, 4), 1.0, torch.zeros(1, 7, 32))


@pytest.mark.parametrize("remat", [False, True])
def test_pins_sit_outside_remat_and_pin_the_gradient(tiny_xl, pin_switch, monkeypatch, remat):
    """The grad pass of the train step (noxattn slider, batch 1) with every
    pin forced through `LayoutPin`: 8 forward copies with or without remat
    (the pins are outside the checkpointed blocks), and 7 backward copies:
    every boundary but the first, whose input depends on no LoRA factor.
    The LoRA gradients equal those of the unpinned UNet (the copy is the
    identity, bit for bit)."""
    _, _, tparams, tlora = tiny_xl
    rng = np.random.default_rng(3)
    x, t, ctx, added = _xl_inputs(rng, batch=1)
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
            {k: torch.from_numpy(v) for k, v in added.items()})

    def grads():
        leaves = {m: {k: v.clone().requires_grad_() for k, v in e.items()} for m, e in tlora.items()}
        out = tunet.apply(tparams, tunet.TINY_XL, *args[:3], added_cond=args[3],
                          lora=SliderLora(weights=leaves, multiplier=1.0), remat=remat)
        flat = [v for e in leaves.values() for k, v in e.items() if k != "alpha"]
        return torch.autograd.grad((out.float() ** 2).mean(), flat)

    plain = grads()
    counter = _PinCounter(monkeypatch)
    out = tunet.apply(tparams, tunet.TINY_XL, *args[:3], added_cond=args[3])
    assert counter.copies == 8 and out.grad_fn is None
    counter.copies = 0
    pinned = grads()
    assert counter.copies == 8 + 7
    for a, b in zip(pinned, plain):
        assert torch.equal(a, b)


def test_xl_prompt_encode_matches_jax(xl_models):
    """Both encoders' penultimate hidden states concatenated (16 + 16 = 32
    wide) and encoder 2's projected pooled output, against the JAX package
    within 1e-5; tokenizer_2 pads with id 0, tokenizer 1 with the EOS id."""
    jm, tm = xl_models
    t1, t2 = (te.tokenizer for te in tm.text_encoders)
    assert t2.pad_token_id == 0 and t1.pad_token_id == t1.eos_token_id
    ids = t2(["a person"])
    eos = int(np.argmax(ids[0] == t2.eos_token_id))
    assert (ids[0, eos + 1:] == 0).all()
    np.testing.assert_array_equal(ids, jm.text_encoders[1].tokenizer(["a person"]))
    prompts = ["a photo of an old person", ""]
    jt, jp = jenc.encode_prompts_xl([te.tokenizer for te in jm.text_encoders],
                                    [te.params for te in jm.text_encoders],
                                    [te.config for te in jm.text_encoders], prompts)
    tt, tp = tenc.encode_prompts_xl([te.tokenizer for te in tm.text_encoders],
                                    [te.params for te in tm.text_encoders],
                                    [te.config for te in tm.text_encoders], prompts)
    assert tt.shape == (2, 16, 32) and tp.shape == (2, 16)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-5)
    assert tm.text_encoders[1].config.hidden_act == "gelu"
    assert tm.text_encoders[1].config.projection_dim == 16


def _jax_crop_draws(key):
    """The three uniforms JAX's get_add_time_ids draws from `key`
    (text2image.py:361-364)."""
    k1, k2, k3 = jax.random.split(key, 3)
    return (float(jax.random.uniform(k1, (), minval=1.0, maxval=3.0)),
            float(jax.random.uniform(k2, (), maxval=1.0)),
            float(jax.random.uniform(k3, (), maxval=1.0)))


@pytest.mark.parametrize("seed", [None, 0, 1, 2])
def test_get_add_time_ids_matches_jax(seed):
    """Static ids, and dynamic crops on JAX's draws: equal bit for bit."""
    if seed is None:
        ref = jt2i.get_add_time_ids(1024, 768)
        out = tt2i.get_add_time_ids(1024, 768)
    else:
        key = jax.random.key(seed)
        ref = jt2i.get_add_time_ids(512, 512, dynamic_crops=True, key=key)
        out = tt2i.get_add_time_ids(512, 512, dynamic_crops=True, draws=_jax_crop_draws(key))
        assert out[0, 0] >= 512 and out[0, 2] <= out[0, 0] - 512
    assert out.dtype == torch.float32 and out.shape == (1, 6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_step_draws_give_a_crop_inside_the_original():
    """`step_draws`' crop uniforms (scale in [1, 3)) give an original size of
    at least the target and a corner inside it; dynamic crops need them."""
    for step in range(20):
        crop = tts.step_draws(3, step, 1, 50, (1, 8, 8, 4), 1.0, crop=True)[3]
        ids = tt2i.get_add_time_ids(512, 512, True, draws=crop)[0]
        assert 512 <= ids[0] < 1536 and 512 <= ids[1] < 1536 and ids[4] == ids[5] == 512
        assert 0 <= ids[2] <= ids[0] - 512 and 0 <= ids[3] <= ids[1] - 512
    with pytest.raises(ValueError, match="crop draws"):
        tt2i.get_add_time_ids(512, 512, True)


@pytest.mark.parametrize("rescale", [0.0, 0.7])
def test_xl_sampling_fn_matches_jax(xl_models, rescale):
    """encode_conditioning -> 4 DDIM steps at 64 px with a slider at per-row
    scales [-1, 0, 1] and start_noise 750, CFG-doubled added conditioning and
    guidance rescale, against JAX's vector-scale make_sampling_fn within
    1e-5 of the latents' largest value; then the VAE within one level."""
    jm, tm = xl_models
    jw = jnet.create_slider_network(jax.random.key(4), jm.unet_params, rank=4,
                                    train_method="noxattn")
    rng = np.random.default_rng(4)
    jw = {k: {**v, "up": jnp.asarray(rng.standard_normal(v["up"].shape) * 0.1, jnp.float32)}
          for k, v in jw.items()}
    tw = from_jax_params(_np(jw))
    lat = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    scales = np.array([-1.0, 0.0, 1.0], np.float32)

    jc, ju, jadd = jt2i.encode_conditioning(jm, "a photo of an old person", "", 64)
    tc, tu, tadd = tt2i.encode_conditioning(tm, "a photo of an old person", "", 64)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    assert sorted(tadd) == sorted(jadd)
    for k in tadd:
        np.testing.assert_allclose(tadd[k].numpy(), np.asarray(jadd[k]), rtol=0, atol=1e-5)

    jfn = jt2i.make_sampling_fn(jm.unet_config, jmake_sampler(jmake_schedule(), "ddim", 4),
                                guidance_rescale=rescale, compute_dtype=jnp.float32, is_xl=True)
    jx = np.asarray(jfn(jm.unet_params, jnp.asarray(lat), *jt2i.tile_conditioning(jc, ju, None, 3)[:2],
                        jw, jnp.asarray(scales), jnp.full((3,), 750.0), jnp.full((3,), 7.5),
                        jax.random.key(0), jt2i.tile_conditioning(jc, ju, jadd, 3)[2]))
    tfn = tt2i.make_sampling_fn(tm.unet_config, tsched.make_sampler(tsched.make_schedule(), "ddim", 4),
                                guidance_rescale=rescale, compute_dtype=torch.float32)
    tx = tfn(tm.unet_params, torch.from_numpy(lat), *tt2i.tile_conditioning(tc, tu, tadd, 3)[:2],
             tw, torch.from_numpy(scales), torch.full((3,), 750.0), torch.full((3,), 7.5),
             tt2i.tile_conditioning(tc, tu, tadd, 3)[2])
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0, atol=1e-5 * np.abs(jx).max())
    ji = np.asarray(jt2i.decode_images(jm.vae_params, jm.vae_config, jnp.asarray(jx)))
    ti = tt2i.decode_images(tm.vae_params, tm.vae_config, tx).numpy()
    assert np.abs(ti.astype(int) - ji.astype(int)).max() <= 1
    assert not np.array_equal(ti[0], ti[2])


def _xl_pairs(n_pairs=2, L=7, D=32, P=16, seed=5):
    """Pair 0 redraws its crop every iteration; pair 1 keeps static ids."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_pairs):
        p = {}
        for k in ("target", "positive", "neutral", "unconditional"):
            p[k] = rng.standard_normal((L, D)).astype(np.float32)
            p[f"pooled_{k}"] = rng.standard_normal((P,)).astype(np.float32)
        p["guidance_signed"] = np.float32(4.0 if i == 0 else -2.0)
        p["time_ids"] = np.array([64, 64, 0, 0, 64, 64], np.float32)
        p["dynamic_crops"] = np.float32(1.0 if i == 0 else 0.0)
        out.append(p)
    return out


def _jax_xl_draws(state, n_pairs, max_steps, shape, init_noise_sigma):
    """The JAX XL step's draws, recomputed from its key as
    text_slider.py:157-180 makes them: pair, t_to, latents and the crop."""
    key = jax.random.fold_in(state.key, state.step)
    k_pair, k_t, k_lat, _, k_crop = jax.random.split(key, 5)
    idx = int(jax.random.randint(k_pair, (), 0, n_pairs))
    t_to = int(jax.random.randint(k_t, (), 1, max_steps))
    lat = np.array((jax.random.normal(k_lat, shape) * init_noise_sigma).astype(jnp.float32))
    return idx, t_to, lat, _jax_crop_draws(k_crop)


def test_xl_train_step_matches_jax(tiny_xl):
    """Four steps of the port's XL step against JAX make_text_slider_step
    (is_xl) on the same weights and JAX's draws, both pairs drawn (one with
    dynamic crops): loss and grad_norm within 1e-5, and the LoRA after each
    update within atol 1e-5 (lr 1e-4, as the SD1.5 step parity)."""
    params, _, tparams, _ = tiny_xl
    lora = jnet.create_slider_network(jax.random.key(1), params, rank=4, train_method="noxattn")
    tlora = from_jax_params(_np(lora))
    max_steps = 5
    sched = jmake_schedule()
    sampler = jmake_sampler(sched, "ddim", max_steps)
    jtx = jopt.make_optimizer("adamw", jopt.make_lr_schedule("constant", 1e-4, 100),
                              trainable_mask=jnet.trainable_mask(lora))
    jstep = jts.make_text_slider_step(
        junet.TINY_XL, sched, sampler, jtx, max_denoising_steps=max_steps, resolution=64,
        batch_size=1, compute_dtype=jnp.float32, remat=False, is_xl=True, donate=False)
    jstate = jts.SliderTrainState.create(jax.random.key(2), lora, jtx)
    raw = _xl_pairs()
    jpairs = jts.stack_prompt_pairs([{k: jnp.asarray(v) for k, v in p.items()} for p in raw])

    tsch = tsched.make_schedule()
    ttx = topt.make_optimizer("adamw", topt.make_lr_schedule("constant", 1e-4, 100),
                              trainable_mask=tnet.trainable_mask(tlora))
    tstep = tts.make_text_slider_step(
        tunet.TINY_XL, tsch, tsched.make_sampler(tsch, "ddim", max_steps), ttx,
        max_denoising_steps=max_steps, resolution=64, batch_size=1,
        compute_dtype=torch.float32, remat=True, is_xl=True)
    tstate = tts.SliderTrainState.create(0, {m: {k: t.clone() for k, t in e.items()}
                                             for m, e in tlora.items()}, ttx)
    tpairs = tts.stack_prompt_pairs(raw)
    seen = set()
    for _ in range(4):
        draws = _jax_xl_draws(jstate, len(raw), max_steps, (1, 8, 8, 4), sampler.init_noise_sigma)
        jstate, jm = jstep(jstate, params, jpairs)
        tstate, tm = tstep(tstate, tparams, tpairs, draws=draws)
        assert (tm["pair"], tm["t_to"]) == (int(jm["pair"]), int(jm["t_to"])) == draws[:2]
        seen.add(tm["pair"])
        assert tm["loss"] == pytest.approx(float(jm["loss"]), abs=1e-5)
        assert tm["grad_norm"] == pytest.approx(float(jm["grad_norm"]), abs=1e-5)
        ref = from_jax_params(_np(jstate.lora))
        for m in ref:
            for k in ("down", "up", "alpha"):
                np.testing.assert_allclose(tstate.lora[m][k].numpy(), ref[m][k].numpy(),
                                           rtol=0, atol=1e-5)
    assert seen == {0, 1}
    with pytest.raises(ValueError, match="crop draws"):
        tstep(tstate, tparams, {k: v[:1] for k, v in tpairs.items()}, draws=(0, 1, draws[2]))


def test_load_sdxl_matches_jax_loader(xl_models):
    jm, tm = xl_models
    assert tm.is_xl and len(tm.text_encoders) == 2
    assert tm.unet_config.addition_embed_type == "text_time"
    ref = from_jax_params(_np(jm.unet_params))
    assert set(ref) == set(tm.unet_params) and "add_embedding" in tm.unet_params
    w = tm.unet_params["add_embedding"]["linear_1"]["weight"]
    assert w.shape == (tm.unet_config.time_embed_dim, 64)
    assert torch.equal(w, ref["add_embedding"]["linear_1"]["weight"])
    proj = tm.text_encoders[1].params["text_projection"]["weight"]
    assert torch.equal(proj, from_jax_params(_np(jm.text_encoders[1].params))
                       ["text_projection"]["weight"])


@pytest.mark.parametrize("method", ["noxattn", "xattn"])
def test_sdxl_lora_module_count_matches_jax(method):
    """create_slider_network's module list over the SDXL-base UNet, the
    reference's 'create LoRA for U-Net: N modules' (280 for both)."""
    jparams = jax.eval_shape(lambda k: junet.init_params(k, junet.SDXL), jax.random.key(0))
    tparams = tunet.init_params(None, tunet.SDXL, device="meta")
    jmods = jnet.target_module_paths(jparams, "lierla", method)
    tmods = tnet.target_module_paths(tparams, "lierla", method)
    assert tmods == jmods and len(tmods) == 280


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def test_serve_xl_http_round_trip(xl_snapshot, xl_models):
    """`cli/serve.py --xl` on the CPU builds the xl-family engine (guidance
    rescale 0.7); /healthz says is_xl, and a /generate of 3 scales padded to
    bucket 4 gives the images of the engine's own sampling function on the
    same rows."""
    from PIL import Image

    jm, _ = xl_models
    engine = tserve.make_engine(tserve.build_parser().parse_args(
        ["--xl", "--base", xl_snapshot, "--device", "cpu", "--precision", "float32",
         "--ddim_steps", "2", "--image_size", "64", "--buckets", "1,4", "--no_warmup"]))
    jw = jnet.create_slider_network(jax.random.key(6), jm.unet_params, rank=4,
                                    train_method="noxattn")
    rng = np.random.default_rng(6)
    jw = {k: {**v, "up": jnp.asarray(rng.standard_normal(v["up"].shape) * 0.1, jnp.float32)}
          for k, v in jw.items()}
    engine.register_slider("age", from_jax_params(_np(jw)))
    server = make_http_server(engine, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        health = _get(base + "/healthz")
        assert health["family"] == "xl" and health["is_xl"] and health["image_size"] == 64
        scales = [-2.0, 0.0, 2.0]
        reply = _post(base + "/generate", {"prompt": "a person", "seed": 3, "slider": "age",
                                           "scales": scales})
        imgs = [np.asarray(Image.open(io.BytesIO(base64.b64decode(im["png"]))))
                for im in reply["images"]]
        assert [im["scale"] for im in reply["images"]] == scales
        assert all(im.shape == (16, 16, 3) for im in imgs)
        assert not np.array_equal(imgs[0], imgs[2])
        assert engine.stats == {"requests": 1, "batches": 1, "rows": 3}
    finally:
        server.shutdown()
        server.server_close()
        engine.close(timeout=60)


def test_xl_engine_decodes_in_slices(xl_snapshot):
    """The SD engine decodes `decode_rows` rows per VAE call: 2048 at 64 px
    (8 M pixels), and a 1-row slice gives the same images within one level."""
    from PIL import Image

    models = tloader.load_sdxl(xl_snapshot, dtype=torch.float32, load_vae=True)
    engine = SliderEngine(models, device="cpu", steps=2, image_size=64,
                          compute_dtype=torch.float32)
    try:
        assert engine.decode_rows == 8 * 1024 * 1024 // 64 ** 2
        whole = engine.generate("a person", seed=2, scales=[0.0, 0.0])
        engine.decode_rows = 1
        sliced = engine.generate("a person", seed=2, scales=[0.0, 0.0])
    finally:
        engine.close(timeout=60)
    for (_, a), (_, b) in zip(whole, sliced):
        a, b = (np.asarray(Image.open(io.BytesIO(p)), dtype=np.int16) for p in (a, b))
        assert np.abs(a - b).max() <= 1


def test_train_xl_cli_end_to_end(xl_snapshot, tmp_path, capsys):
    """`train_text_slider --xl` on the CPU: a dynamic-crop pair at 64 px, 4
    iterations, saves, and a resume from the state saved after step 2 that
    repeats the first run's step 3."""
    (tmp_path / "prompts.yaml").write_text(
        "- target: person\n  positive: old person\n  unconditional: young person\n"
        "  neutral: person\n  action: enhance\n  guidance_scale: 2\n  resolution: 64\n"
        "  dynamic_crops: true\n")
    (tmp_path / "config.yaml").write_text(
        f"prompts_file: {tmp_path / 'prompts.yaml'}\n"
        f"pretrained_model:\n  name_or_path: {xl_snapshot}\n"
        "network:\n  rank: 2\n  alpha: 1.0\n  training_method: noxattn\n"
        "train:\n  precision: float32\n  iterations: 4\n  lr: 0.001\n  max_denoising_steps: 3\n"
        f"save:\n  name: xl\n  path: {tmp_path / 'out'}\n  per_steps: 2\n"
        "tpu:\n  remat: true\n  state_checkpoint_every: 2\n")
    args = ["--config_file", str(tmp_path / "config.yaml"), "--device", "cpu", "--xl"]
    seen = []
    final = tcli.main(tcli.build_parser().parse_args(args),
                      on_step=lambda i, s, m: seen.append((i, m)))
    out = capsys.readouterr().out
    n_modules = len(jnet.target_module_paths(junet.init_params(jax.random.key(0), junet.TINY_XL),
                                             "lierla", "noxattn"))
    assert f"create LoRA for U-Net: {n_modules} modules." in out
    assert [i for i, _ in seen] == [0, 1, 2, 3]
    assert any(e["up"].abs().max() > 0 for e in final.values())
    run = "xl_alpha1.0_rank2_noxattn"
    out_dir = tmp_path / "out" / run
    assert sorted(os.listdir(out_dir)) == sorted(
        f"{run}{s}" for s in ("_2steps.safetensors", "_last.safetensors", "_metadata.json",
                              "_trainstate.pt"))
    resumed = []
    tcli.main(tcli.build_parser().parse_args(
        args + ["--resume", str(out_dir / f"{run}_trainstate.pt")]),
        on_step=lambda i, s, m: resumed.append((i, m)))
    assert [i for i, _ in resumed] == [3]
    assert resumed[0][1]["t_to"] == seen[3][1]["t_to"]
    assert resumed[0][1]["loss"] == pytest.approx(seen[3][1]["loss"], rel=1e-6)
