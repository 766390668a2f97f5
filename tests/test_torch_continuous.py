"""Step-level continuous batching in the port, on the CPU.

`text2image.make_continuous_step_fn` against the JAX package's on TINY with
shared weights (`from_jax_params`), under DDIM and LMS, with rows at mixed
step positions: rows that advance the whole chunk, rows that finish inside
it and freeze, and a free row that never moves; within 1e-5 of the largest
value in f32 (REL, as tests/test_torch_sampling.py).

Then the port's continuous engine against its own batch-boundary engine at
the same bucket, on the tiny SD snapshot in f32: the PNG bytes of a solo
request, of a request joining a live batch mid-denoise (DDIM and LMS: the
LMS join zeroes the joiner's history columns, which the JAX package leaves
unpinned) and of the request it joined, and of rank-bucket-deferred
requests, are equal. These are the contracts of
tests/test_serving_continuous.py (JAX, `slow`), held here without running
JAX engines. tests/test_torch_continuous_engine.py holds bf16 and SDXL,
validation, the CLI and the other departures from the JAX worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import make_tiny_snapshot
from torch_continuous_helpers import STEPS, make_engines, join_midflight, pngs, make_sliders

from sliders_tpu.diffusion import make_sampler as jmake_sampler
from sliders_tpu.diffusion import make_schedule as jmake_schedule
from sliders_tpu.lora import batch as jbatch
from sliders_tpu.lora import network as jnet
from sliders_tpu.models import unet2d as junet
from sliders_tpu.pipelines import text2image as jt2i
from sliders_tpu_torch.diffusion import make_sampler, make_schedule
from sliders_tpu_torch.lora.batch import stack_sliders
from sliders_tpu_torch.lora.network import create_slider_network
from sliders_tpu_torch.models import unet2d as tunet
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.pipelines import text2image as tt2i

REL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(out, ref, rel=REL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=rel * float(np.abs(ref).max()))


@pytest.mark.parametrize("kind", ["ddim", "lms"])
def test_step_fn_matches_jax_at_mixed_step_positions(kind):
    """Rows at step positions 0, 2, 5 and n (free) through one chunk of 3
    steps: row 2 runs one step and freezes, row 3 never moves; per-row
    slider scales, gates and guidance; a stacked adapter of two sliders.
    LMS starts from a random history, so the per-row coefficient rows and
    the history-major freeze both show. Each row's latents are at its own
    noise level (std sqrt(sigma_i^2 + 1) under LMS), as a row at that step
    position holds them: latents of the first step's scale (14.6) at the
    last step (sigma 0.03) would make the derivative (x - x0) / sigma cancel
    in f32 in both packages alike."""
    params = junet.init_params(jax.random.key(0), junet.TINY)
    sliders = []
    for seed in (1, 2):
        w = jnet.create_slider_network(jax.random.key(seed), params, rank=2,
                                       train_method="noxattn")
        ks = iter(jax.random.split(jax.random.key(seed + 10), len(w)))
        sliders.append({m: {**e, "up": jax.random.normal(next(ks), e["up"].shape) * 0.3}
                        for m, e in w.items()})
    rows = [0, 1, 0, 1]
    jw = jbatch.stack_sliders([sliders[r] for r in rows], round_ranks_pow2=True)
    tw = stack_sliders([from_jax_params(_np(sliders[r])) for r in rows],
                       round_ranks_pow2=True)
    tparams = from_jax_params(_np(params))
    rng = np.random.default_rng(3)
    B, n = 4, STEPS
    js, ts = jmake_sampler(jmake_schedule(), kind, n), make_sampler(make_schedule(), kind, n)
    step_idx = np.array([0, 2, 5, n], np.int32)
    std = np.ones(B)
    if kind == "lms":
        sig = ts.sigmas.double().numpy()[np.minimum(step_idx, n - 1)]
        std = np.sqrt(sig ** 2 + 1.0)
    x = (rng.standard_normal((B, 8, 8, 4)) * std[:, None, None, None]).astype(np.float32)
    cond, uncond = (rng.standard_normal((B, 7, 32)).astype(np.float32) for _ in range(2))
    scale = np.array([1.0, -1.0, 2.0, 0.5], np.float32)
    sn = np.array([1000.0, 500.0, 800.0, 1000.0], np.float32)
    g = np.array([7.5, 5.0, 7.5, 3.0], np.float32)
    hist = {}
    if kind == "lms":
        hist = {"derivs": (rng.standard_normal((4, B, 8, 8, 4)) * 0.5).astype(np.float32)}
    jfn = jt2i.make_continuous_step_fn(junet.TINY, js, chunk=3, compute_dtype=jnp.float32)
    jx, js_state = jfn(params, jnp.asarray(x), {k: jnp.asarray(v) for k, v in hist.items()},
                       jnp.asarray(step_idx), cond, uncond, jw, scale, sn, g, None)
    tfn = tt2i.make_continuous_step_fn(tunet.TINY, ts, chunk=3, compute_dtype=torch.float32)
    tx, ts_state = tfn(tparams, torch.tensor(x), {k: torch.tensor(v) for k, v in hist.items()},
                       step_idx, torch.tensor(cond), torch.tensor(uncond), tw,
                       torch.tensor(scale), torch.tensor(sn), torch.tensor(g), None)
    _close(tx, jx)
    assert torch.equal(tx[3], torch.tensor(x[3])), "the free row moved"
    assert not torch.equal(tx[2], torch.tensor(x[2])), "row 2 did not run its last step"
    assert set(ts_state) == set(js_state)
    for k in hist:
        _close(ts_state[k], js_state[k])
        assert torch.equal(ts_state[k][:, 3], torch.tensor(hist[k][:, 3]))


@pytest.mark.parametrize("i", [2, [0, 2, 5, 5]], ids=["one-position", "per-row"])
def test_lms_step_on_bf16_latents_with_f32_noise_matches_jax(i):
    """The serving engines' per-row guidance vector is f32, so CFG makes eps
    f32 beside bf16 latents: the LMS history and the update promote to f32,
    with the coefficients rounded to bf16 first, as JAX promotes them."""
    js, ts = jmake_sampler(jmake_schedule(), "lms", STEPS), make_sampler(make_schedule(), "lms",
                                                                          STEPS)
    rng = np.random.default_rng(8)
    x, eps = (rng.standard_normal((4, 8, 8, 4)).astype(np.float32) for _ in range(2))
    hist = rng.standard_normal((4, 4, 8, 8, 4)).astype(np.float32)
    jx, jstate = js.step(jnp.asarray(i), jnp.asarray(eps), jnp.asarray(x).astype(jnp.bfloat16),
                         {"derivs": jnp.asarray(hist).astype(jnp.bfloat16)})
    tx, tstate = ts.step(torch.tensor(i), torch.tensor(eps), torch.tensor(x).bfloat16(),
                         {"derivs": torch.tensor(hist).bfloat16()})
    assert tx.dtype == tstate["derivs"].dtype == torch.float32
    _close(tx, jx)
    _close(tstate["derivs"], jstate["derivs"])


def test_step_fn_refuses_stochastic_samplers():
    for kind in ("ddpm", "euler_a"):
        with pytest.raises(NotImplementedError, match="stochastic"):
            tt2i.make_continuous_step_fn(tunet.TINY, make_sampler(make_schedule(), kind, 4),
                                         chunk=2)


# -- the engine --------------------------------------------------------------


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    return make_tiny_snapshot(str(tmp_path_factory.mktemp("cont") / "sd_tiny"))


@pytest.fixture(scope="module", params=["ddim", "lms"])
def engines(snapshot, request):
    regular, cont = make_engines(snapshot, request.param)
    yield regular, cont
    regular.close(timeout=60)
    cont.close(timeout=60)


def test_solo_request_equals_the_boundary_engine(engines):
    """The chunked program == the whole-loop program, byte for byte, at the
    same bucket (3 scales pad to 4 rows in both engines), with a slider and
    without (the LoRA-free program)."""
    regular, cont = engines
    kw = dict(seed=7, slider="age", scales=[-1.0, 0.0, 1.0])
    ref, out = regular.generate("photo", **kw), cont.generate("photo", **kw)
    assert [s for s, _ in out] == [s for s, _ in ref]
    assert pngs(out) == pngs(ref)
    assert len(set(pngs(out))) == 3
    assert pngs(cont.generate("a cat", seed=9, scales=[0.0, 0.0])) == \
        pngs(regular.generate("a cat", seed=9, scales=[0.0, 0.0]))


def test_midflight_join_equals_solo_runs(engines):
    """A request joining a LIVE batch gets its solo images, and the request
    it joined is untouched (another slider of the same structure, so the
    stacked rows differ); under LMS the joiner's history columns restart."""
    regular, cont = engines
    a = ("photo", dict(seed=31, slider="age", scales=[1.0, -1.0]))
    b = ("a cat", dict(seed=32, slider="smile", scales=[0.5]))
    ra, rb, joins = join_midflight(cont, a, b)
    assert joins == 1
    assert pngs(ra) == pngs(regular.generate(a[0], **a[1]))
    assert pngs(rb) == pngs(regular.generate(b[0], **b[1]))


def test_overlap_takes_fewer_chunks(engines):
    """Two overlapping one-scale requests take fewer chunks than two solo
    runs (2 x 6 at chunk 1): the second joins after the first chunk."""
    _, cont = engines
    chunks = cont.stats["chunks"]
    join_midflight(cont, ("photo", dict(seed=51, slider="age", scales=[1.0])),
          ("photo", dict(seed=52, slider="age", scales=[1.0])))
    assert cont.stats["chunks"] - chunks == STEPS + 1


def test_rank_bucket_defer_and_signature_classes(engines):
    """Admission needs the live batch's pow2 rank bucket per module exactly;
    a request of another bucket waits for its own batch and still gets its
    solo images. A slider of another module set never shares a batch."""
    regular, cont = engines
    q = {name: cont._make_pending("x", slider=name, scales=[0.0])
         for name in ("age", "smile", "wide")}
    b_age, b_wide = cont._cont_req_buckets(q["age"]), cont._cont_req_buckets(q["wide"])
    assert set(b_age.values()) == {2} and set(b_wide.values()) == {4}
    assert not cont._cont_fits(q["wide"], b_age) and not cont._cont_fits(q["age"], b_wide)
    assert cont._cont_fits(q["smile"], b_age)
    assert cont._cont_req_buckets(cont._make_pending("x", scales=[0.0])) is None

    pa = cont._make_pending("photo", seed=61, slider="age", scales=[1.0])
    pb = cont._make_pending("photo", seed=61, slider="wide", scales=[1.0])
    cont._submit([pa, pb])
    assert pngs(cont._wait(pa)) == pngs(regular.generate("photo", seed=61, slider="age",
                                                           scales=[1.0]))
    assert pngs(cont._wait(pb)) == pngs(regular.generate("photo", seed=61, slider="wide",
                                                           scales=[1.0]))
    xonly = create_slider_network(torch.Generator().manual_seed(30),
                                  cont.models.unet_params, rank=2, train_method="xattn")
    cont.register_slider("xonly", xonly)
    regular.register_slider("xonly", xonly)
    out = cont.generate("photo", seed=62, slider="xonly", scales=[1.0, 0.0])
    assert pngs(out) == pngs(regular.generate("photo", seed=62, slider="xonly",
                                                scales=[1.0, 0.0]))
