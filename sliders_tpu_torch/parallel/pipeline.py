"""Pipeline parallelism over the mesh's pp axis: GPipe microbatching of the
FLUX block stacks (port of the forward of sliders_tpu/parallel/pipeline.py).

FLUX-dev's 19 double and 38 single blocks are 23.8 GB in bf16; over pp
stages each rank holds only its stage's blocks (`flux_pp_params`, or
`pp_keep` while the weights are drawn or loaded) and the replicated small
parameters (the embedders, `norm_out`, the model-level `proj_out`).

Stage s holds the blocks that the JAX package's padded stack gives it,
[s * ceil(n / pp), min(n, (s + 1) * ceil(n / pp))) of each family
(`stage_range`): FLUX-dev at pp = 2 gives doubles 0-9 / 10-18 and singles
0-18 / 19-37. JAX pads each stack to a multiple of pp with all-zero blocks,
exact identities (every adaLN-zero gate is 0, pipeline.py:107-129); in
eager PyTorch a stage looks its blocks and its LoRA entries up by their
absolute names, so the port needs neither stacked layer trees nor pad
blocks, and a stage past the end of a stack holds none of it and passes its
microbatches on.

`pipeline_blocks` runs one stack on every stage: stage 0 injects microbatch
m (or receives it from the last stage, the ring's wrap), each stage applies
its blocks and sends the result to s + 1 with isend / irecv, posting the
next microbatch's receive before it computes, so that stages overlap
(bubble (pp - 1) / (M + pp - 1) as in JAX); the last stage hands each
finished microbatch to stage 0. `flux_apply_pp` runs the double stack, then
the single stack on cat([txt, img]) (the last stage's hand-over), then
`final_layer` on stage 0, where the sampler runs; the other stages return
None. `temb`, the per-row slider multiplier and the per-row adapter rows
ride each microbatch: the multiplier and stacked adapters are sliced to the
microbatch's rows, so the port serves per-row sliders under pp, which the
JAX `pipeline_blocks` refuses ("pipeline LoRA multiplier must be a
scalar", ROADMAP queue 3).

Every stage calls `flux_apply_pp` with the same arguments (as every device
runs the JAX shard_map); stages past 0 read only the inputs' shapes and the
ids. A server drives the other stages through a `StageChannel`: stage 0
announces each forward (shapes, ids, the step's per-row multiplier) and the
followers (`serving/server.py`) run theirs. The forward only: the
differentiable pipeline is not ported yet (ROADMAP queue 1, item 15).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from sliders_tpu_torch.lora.batch import is_stacked
from sliders_tpu_torch.models import flux
from sliders_tpu_torch.ops.basic import SliderLora
from sliders_tpu_torch.parallel.collectives import irecv_tensors, isend_tensors, wait_all
from sliders_tpu_torch.parallel.mesh import PIPE_AXIS

FAMILIES = ("transformer_blocks", "single_transformer_blocks")


def stage_range(n: int, stages: int, stage: int) -> tuple:
    """Layers [lo, hi) of `stage` in a stack of n over `stages`: shares of
    ceil(n / stages) in stage order, the last ones short or empty (the JAX
    package's zero-padded stack without its pad blocks)."""
    share = -(-n // stages)
    lo = min(stage * share, n)
    return lo, min(lo + share, n)


def stage_layers(cfg, stages: int, stage: int) -> dict:
    """{family: range of the blocks `stage` holds}."""
    return {fam: range(*stage_range(n, stages, stage))
            for fam, n in zip(FAMILIES, (cfg.num_layers, cfg.num_single_layers))}


def split_microbatches(tree, num_microbatches: int):
    """Leading batch dim B -> (M, B // M) on every leaf (JAX's layout and
    ValueError)."""
    def f(a):
        b = a.shape[0]
        if b % num_microbatches:
            raise ValueError(f"batch {b} not divisible by num_microbatches={num_microbatches}")
        return a.reshape((num_microbatches, b // num_microbatches) + tuple(a.shape[1:]))

    return {k: f(v) for k, v in tree.items()}


def merge_microbatches(tree):
    return {k: v.reshape((v.shape[0] * v.shape[1],) + tuple(v.shape[2:]))
            for k, v in tree.items()}


def check_uniform_lora(weights: dict, prefix: str, n_layers: int) -> None:
    """JAX's `stack_layer_lora` rule, kept so that both packages accept the
    same adapters: every relative name of a `prefix` family's entries must
    exist in every layer (a traced stage index cannot pick between
    per-layer trees there)."""
    per_rel: dict = {}
    for key in weights:
        if key.startswith(prefix + "."):
            idx, rel = key[len(prefix) + 1:].split(".", 1)
            per_rel.setdefault(rel, set()).add(int(idx))
    for rel, have in per_rel.items():
        missing = [i for i in range(n_layers) if i not in have]
        if missing:
            raise ValueError(f"pipeline LoRA needs uniform targeting: {prefix}.*.{rel} "
                             f"missing in layers {missing}")


def _lora_rows(lora: Optional[SliderLora], lo: int, hi: int) -> Optional[SliderLora]:
    """The slider of rows [lo, hi): a per-row multiplier and a per-row
    stacked adapter sliced, a scalar and a solo adapter as they are."""
    if lora is None:
        return None
    mult = lora.multiplier
    if torch.is_tensor(mult) and mult.ndim > 0:
        mult = mult[lo:hi]
    weights = lora.weights
    if is_stacked(weights):
        weights = {n: {k: v[lo:hi] for k, v in e.items()} for n, e in weights.items()}
    return SliderLora(weights, mult)


def pipeline_blocks(block_fn: Callable, layers, mesh, *, num_microbatches: int, template: dict,
                    device, inputs: Optional[list] = None, finish: Optional[Callable] = None,
                    finish_template: Optional[dict] = None, tag: int = 0,
                    from_tag: int = 0) -> Optional[list]:
    """One block stack over the pp axis with GPipe microbatching.

    `block_fn(layer, state, m) -> state` applies block `layer` to
    microbatch m's state (a dict of tensors shaped as `template`, {key:
    (shape, dtype)}); `layers` are this stage's layer indices, in order.
    Stage 0 takes microbatch m from `inputs[m]`, or without `inputs`
    receives it from the last stage (what that stage's previous call
    handed over). The last stage applies `finish` to each finished state
    (shaped as `finish_template`) and hands it to stage 0; with one stage
    the finished states are returned, else None on every stage. `tag`
    separates the messages of one call from another's; `from_tag` is the
    tag of the call whose hand-over stage 0 receives."""
    stages, stage = mesh.size(PIPE_AXIS), mesh.coord(PIPE_AXIS)
    finish = finish or (lambda st: st)
    finish_template = finish_template or template
    keys, fkeys = sorted(template), sorted(finish_template)
    specs = [template[k] for k in keys]
    last = stages - 1
    src = None
    if stage > 0:
        src = stage - 1
    elif inputs is None:
        src = last

    def receive(m):
        base = tag if stage > 0 else from_tag + 8
        return irecv_tensors(specs, mesh, src, base + 16 * m, device)

    sends, out = [], []
    nxt = receive(0) if src is not None else None
    for m in range(num_microbatches):
        if src is None:
            state = inputs[m]
        else:
            state = dict(zip(keys, nxt()))
            if m + 1 < num_microbatches:
                nxt = receive(m + 1)
        for layer in layers:
            state = block_fn(layer, state, m)
        if stage < last:
            sends += isend_tensors([state[k] for k in keys], mesh, stage + 1, tag + 16 * m)
            continue
        done = finish(state)
        if stages == 1:
            out.append(done)
        else:
            sends += isend_tensors([done[k] for k in fkeys], mesh, 0, tag + 8 + 16 * m)
    wait_all(sends)
    return out if stages == 1 else None


def receive_handover(mesh, num_microbatches: int, template: dict, device, tag: int) -> list:
    """Stage 0's receipt of the states the last stage handed over in the
    call of `tag` (`pipeline_blocks`' `finish`)."""
    keys = sorted(template)
    specs = [template[k] for k in keys]
    last = mesh.size(PIPE_AXIS) - 1
    return [dict(zip(keys, irecv_tensors(specs, mesh, last, tag + 8 + 16 * m, device)()))
            for m in range(num_microbatches)]


# While a server's channel is idle, stage 0 sends ("ping",) this often (s),
# so that no follower's wait reaches the process group's time-out.
HEARTBEAT_S = 60.0


class StageChannel:
    """Stage 0's control messages to the other stages of a pp mesh
    (`broadcast_object_list` over the pp group): a server's followers
    block in `listen` between requests. `turn(msg)` holds the channel for a
    message and the pipeline work it starts; while the channel is idle,
    stage 0 sends ("ping",) every HEARTBEAT_S seconds (a dead rank still
    fails the others within the time-out).

    A raise inside a turn (an error on stage 0 after it announced the
    forward, or a follower's death surfacing in a receive) leaves the
    other stages waiting for messages that no later call can match, so it
    ends the pipeline: the channel records the error (`failed`), sends
    nothing more, refuses every later turn, and calls `on_failure(error)`
    if set (the server's shut-down). A follower that raises leaves its loop
    and its process exits, which fails stage 0's next receive."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = mesh.group(PIPE_AXIS)
        self.src = dist.get_global_rank(self.group, 0)
        self.leader = mesh.coord(PIPE_AXIS) == 0
        self.failed: Optional[BaseException] = None
        self.on_failure: Optional[Callable] = None
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._idle_since = time.monotonic()
        if self.leader:
            self._beat = threading.Thread(target=self._heartbeat, daemon=True)
            self._beat.start()

    def _send(self, msg) -> None:
        dist.broadcast_object_list([msg], src=self.src, group=self.group)
        self._idle_since = time.monotonic()

    @contextlib.contextmanager
    def turn(self, msg):
        with self._lock:
            if self.failed is not None:
                raise RuntimeError("the pipeline failed in an earlier call and serves no "
                                   "more") from self.failed
            if self._closed.is_set():
                raise RuntimeError("the stage channel is closed")
            try:
                self._send(msg)
                yield
            except BaseException as e:
                self._fail(e)
                raise

    def _fail(self, error: BaseException) -> None:
        self.failed = error
        self._closed.set()
        if self.on_failure is not None:
            self.on_failure(error)

    def announce(self, msg) -> None:
        with self.turn(msg):
            pass

    def listen(self):
        box = [None]
        dist.broadcast_object_list(box, src=self.src, group=self.group)
        return box[0]

    def _heartbeat(self) -> None:
        while not self._closed.wait(HEARTBEAT_S / 4):
            with self._lock:
                if not self._closed.is_set() and \
                        time.monotonic() - self._idle_since >= HEARTBEAT_S:
                    try:
                        self._send(("ping",))
                    except Exception as e:  # a follower is gone
                        self._fail(e)

    def close(self) -> None:
        """Send ("close",) once, unless the pipeline failed; the followers
        leave their loop."""
        with self._lock:
            if not self._closed.is_set():
                self._send(("close",))
                self._closed.set()


def flux_apply_pp(params: dict, cfg, packed_latents: torch.Tensor, timestep: torch.Tensor,
                  pooled: torch.Tensor, encoder_hidden_states: torch.Tensor, txt_ids_arr,
                  img_ids_arr, mesh, guidance: Optional[torch.Tensor] = None,
                  lora: Optional[SliderLora] = None, num_microbatches: int = 1,
                  channel: Optional[StageChannel] = None) -> Optional[torch.Tensor]:
    """`models.flux.apply` with both block stacks pipelined over the mesh's
    pp axis, on `params` from `flux_pp_params` (this stage's blocks). Every
    stage calls it (stages past 0 read only the inputs' shapes); returns
    the velocity on stage 0 and None on the others. `lora` may carry a
    per-row multiplier and a per-row stacked adapter. With `channel`,
    stage 0 first announces the forward to the followers of a server.
    Raises JAX's ValueErrors for a batch that `num_microbatches` does not
    divide and for non-uniform LoRA targeting (on every stage of a call
    without a channel, on stage 0 before it announces with one)."""
    stages, stage = mesh.size(PIPE_AXIS), mesh.coord(PIPE_AXIS)
    M = num_microbatches
    B, L_img = packed_latents.shape[:2]
    L_txt = encoder_hidden_states.shape[1]
    split_microbatches({"x": packed_latents}, M)  # JAX's error for a B that M does not divide
    if lora is not None and (channel is None or stage == 0):
        check_uniform_lora(lora.weights, FAMILIES[0], cfg.num_layers)
        check_uniform_lora(lora.weights, FAMILIES[1], cfg.num_single_layers)
    b, dtype, D = B // M, packed_latents.dtype, cfg.inner_dim
    device = params["proj_out"]["weight"].device
    txt_ids = torch.as_tensor(txt_ids_arr)
    img_ids = torch.as_tensor(img_ids_arr)
    layers = stage_layers(cfg, stages, stage)
    turn = contextlib.nullcontext()
    if channel is not None and stage == 0:
        mult = None if lora is None else torch.as_tensor(lora.multiplier).detach().cpu()
        turn = channel.turn(("forward", {
            "shape": (B, L_img, packed_latents.shape[2]), "txt_len": L_txt, "dtype": dtype,
            "microbatches": M, "txt_ids": txt_ids.cpu(), "img_ids": img_ids.cpu(),
            "multiplier": mult}))
    with turn:
        cos, sin = flux.rope_tables(torch.cat([txt_ids, img_ids]).to(device), cfg)
        inputs, temb = None, None
        if stage == 0:
            img, txt, temb = flux.embed_inputs(params, cfg, packed_latents, timestep, pooled,
                                               encoder_hidden_states, guidance)
            mbs = split_microbatches({"img": img, "txt": txt, "temb": temb}, M)
            inputs = [{k: v[m] for k, v in mbs.items()} for m in range(M)]

        def double_fn(i, state, m):
            img, txt = flux._double_block(
                params[FAMILIES[0]][str(i)], state["img"], state["txt"], state["temb"], cos,
                sin, cfg, _lora_rows(lora, m * b, (m + 1) * b), f"{FAMILIES[0]}.{i}")
            return {"img": img, "txt": txt, "temb": state["temb"]}

        def single_fn(i, state, m):
            x = flux._single_block(params[FAMILIES[1]][str(i)], state["x"], state["temb"], cos,
                                   sin, cfg, _lora_rows(lora, m * b, (m + 1) * b),
                                   f"{FAMILIES[1]}.{i}")
            return {"x": x, "temb": state["temb"]}

        t_double = {"img": ((b, L_img, D), dtype), "txt": ((b, L_txt, D), dtype),
                    "temb": ((b, D), dtype)}
        t_single = {"x": ((b, L_txt + L_img, D), dtype), "temb": ((b, D), dtype)}
        t_out = {"img": ((b, L_img, D), dtype)}
        handed = pipeline_blocks(
            double_fn, layers[FAMILIES[0]], mesh, num_microbatches=M, template=t_double,
            device=device, inputs=inputs,
            finish=lambda st: {"x": torch.cat([st["txt"], st["img"]], dim=1),
                               "temb": st["temb"]},
            finish_template=t_single, tag=0)
        outs = pipeline_blocks(
            single_fn, layers[FAMILIES[1]], mesh, num_microbatches=M, template=t_single,
            device=device, inputs=handed,
            finish=lambda st: {"img": st["x"][:, L_txt:]}, finish_template=t_out, tag=4096,
            from_tag=0)
        if stage != 0:
            return None
        if outs is None:
            outs = receive_handover(mesh, M, t_out, device, tag=4096)
        img = merge_microbatches({"img": torch.stack([o["img"] for o in outs])})["img"]
        return flux.final_layer(params, img, temb)


def pp_keep(mesh, cfg):
    """The `keep` hook of `flux.init_params` / `flux.keep_blocks` that keeps
    the blocks of this rank's stage and drops the others."""
    layers = stage_layers(cfg, mesh.size(PIPE_AXIS), mesh.coord(PIPE_AXIS))

    def keep(prefix, block):
        family, i = prefix.rsplit(".", 1)
        return block if int(i) in layers[family] else None

    return keep


def flux_pp_params(mesh, params: dict, cfg) -> dict:
    """This rank's FLUX tree under pp: its stage's blocks of each family
    (absolute names kept) and the replicated small parameters."""
    return flux.keep_blocks(params, pp_keep(mesh, cfg))
