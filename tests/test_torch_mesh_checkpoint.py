"""Sharded train states (`training/checkpoint.py`) and resumes across world
sizes on the CPU (gloo ranks of `tests/torch_mesh_helpers.run_ranks`):

- the commit protocol: two steps kept, a leftover `.tmp` ignored, the
  directory told from a JAX orbax one and from a `.pt` file;
- a text state saved at dp = 2 restored at world 1 and one saved at world
  1 restored at dp = 2, bit for bit, the optimizer's count and the
  adaptive optimizers' scalars included;
- a fleet state (rows sharded over dp) saved at dp = 2 and read at world 1,
  and saved at world 1 and read at dp = 2;
- through the text CLI: a run resumed from its `.dcp` state at dp = 2
  equal to the straight run bit for bit, the same state resumed at world 1
  (per_device_batch 2: the same global batch) and a world-1 `.pt` state
  resumed at dp = 2 equal to it within atol 1e-5 (the rows' UNet calls
  split differently, as in `tests/test_torch_mesh_training.py`).
"""

import os

import pytest
import torch
from torch_mesh_helpers import checkpoint_rank, run_config, run_ranks, text_cli_rank
from torch_tiny_snapshot import write_tiny_snapshot

from sliders_tpu_torch.cli import train_text_slider as tcli
from sliders_tpu_torch.training import checkpoint as ck
from sliders_tpu_torch.training import driver as tdriver
from sliders_tpu_torch.training import optimizers as topt
from sliders_tpu_torch.training.text_slider import SliderTrainState

RUN = "m_alpha1.0_rank2_noxattn"


def _state(step: int, rows: int = 0, optimizer: str = "adamw", seed: int = 11):
    """A train state with random LoRA leaves (a fleet of `rows` rows when
    rows > 0) and an optimizer state after `step` updates."""
    g = torch.Generator().manual_seed(step)
    lead = (rows,) if rows else ()
    lora = {f"m{i}.to_q": {"down": torch.randn(*lead, 2, 6, generator=g),
                           "up": torch.randn(*lead, 6, 2, generator=g),
                           "alpha": torch.full(lead, 2.0)} for i in range(3)}
    tx = topt.make_optimizer(optimizer, lambda s: 1e-3)
    state = SliderTrainState.create(seed, lora, tx)
    grads = {m: {k: torch.randn(t.shape, generator=g) for k, t in e.items()}
             for m, e in lora.items()}
    for _ in range(step):
        tx.update(state.lora, grads, state.opt_state)
        state.step += 1
    return state


def _assert_equal_trees(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_equal_trees(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert type(a) is type(b) and a == b, where


def _zeros_like_state(state):
    def z(t):
        if isinstance(t, dict):
            return {k: z(v) for k, v in t.items()}
        return torch.zeros_like(t) if isinstance(t, torch.Tensor) else 0
    return SliderTrainState(step=0, seed=0, lora=z(state.lora), opt_state=z(state.opt_state))


@pytest.mark.parametrize("optimizer", ["adamw", "prodigy", "dadaptadamw"])
def test_commit_keeps_two_steps_ignores_tmp_and_round_trips_exactly(tmp_path, optimizer):
    d = tmp_path / "x_trainstate.dcp"
    for step in (1, 2, 3):
        ck.save_sharded(str(d), _state(step, optimizer=optimizer))
    assert sorted(os.listdir(d)) == ["2", "3"]
    # a save killed halfway leaves its .tmp behind; resume ignores it
    (d / "4.tmp").mkdir()
    (d / "4.tmp" / "partial").write_bytes(b"\0")
    assert ck.latest_step(str(d)) == 3 and ck.is_dcp_state(str(d))
    want = _state(3, optimizer=optimizer)
    got = ck.restore_sharded(str(d), _zeros_like_state(want))
    assert (got.step, got.seed) == (3, 11)
    _assert_equal_trees(want.lora, got.lora)
    _assert_equal_trees(want.opt_state, got.opt_state)  # count an int, the scalars exact
    # load_train_state tells it from a JAX orbax directory and a .msgpack file
    got = tdriver.load_train_state(str(d), "cpu", template=_zeros_like_state(want))
    _assert_equal_trees(want.opt_state, got.opt_state)
    orbax = tmp_path / "x_trainstate.orbax"
    (orbax / "3").mkdir(parents=True)
    for jax_state in (orbax, tmp_path / "x_trainstate.msgpack"):
        with pytest.raises(ValueError, match="item 15"):
            tdriver.load_train_state(str(jax_state), "cpu", template=want)


def test_text_state_dp2_to_world1_and_back(tmp_path):
    want = _state(4)
    d2 = tmp_path / "dp2.dcp"
    run_ranks(checkpoint_rank, 2, "save", str(d2), want.state_dict(), "", tag="save dp=2")
    got = ck.restore_sharded(str(d2), _zeros_like_state(want))
    _assert_equal_trees(want.state_dict(), got.state_dict())

    d1 = tmp_path / "w1.dcp"
    ck.save_sharded(str(d1), want)
    out = tmp_path / "restored"
    run_ranks(checkpoint_rank, 2, "restore", str(d1), want.state_dict(), str(out),
              tag="restore dp=2")
    for rank in (0, 1):
        _assert_equal_trees(want.state_dict(), torch.load(f"{out}.{rank}"))


def test_fleet_rows_reshard_between_dp2_and_world1(tmp_path):
    """Four fleet rows: saved at dp = 2 (two a rank, DTensors sharded on the
    row axis) and read whole at world 1; saved whole at world 1 and read at
    dp = 2, each rank its two rows."""
    want = _state(3, rows=4)
    sd = dict(want.state_dict(), rows=True)
    d2 = tmp_path / "fleet_dp2.dcp"
    run_ranks(checkpoint_rank, 2, "save", str(d2), sd, "", tag="fleet save dp=2")
    got = ck.restore_sharded(str(d2), _zeros_like_state(want))
    _assert_equal_trees(want.state_dict(), got.state_dict())

    d1 = tmp_path / "fleet_w1.dcp"
    ck.save_sharded(str(d1), want)
    out = tmp_path / "fleet_restored"
    run_ranks(checkpoint_rank, 2, "restore", str(d1), sd, str(out), tag="fleet restore dp=2")
    for rank in (0, 1):
        part = torch.load(f"{out}.{rank}")
        _assert_equal_trees(tdriver._slice_rows(want.lora, 2 * rank, 2 * rank + 2),
                            part["lora"])
        _assert_equal_trees(tdriver._slice_rows(want.opt_state, 2 * rank, 2 * rank + 2),
                            part["opt_state"])


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt_cli")
    snap = write_tiny_snapshot(str(root / "sd_tiny"))
    (root / "age.yaml").write_text(
        "- target: person\n  positive: old person\n  unconditional: ''\n"
        "  neutral: person\n  action: enhance\n  guidance_scale: 2\n"
        "  resolution: 64\n  batch_size: 1\n")
    return root, snap


def _cli(root, snap, out, iterations, tpu, extra=()):
    return ["--config_file", run_config(root, snap, out, iterations, tpu), "--device", "cpu",
            *extra]


def test_resumed_runs_equal_the_straight_run(snapshot, tmp_path):
    root, snap = snapshot
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        every = "  dp: 2\n  state_checkpoint_every: 1\n"
        straight = tmp_path / "straight.pt"
        run_ranks(text_cli_rank, 2, _cli(root, snap, "a", 3, every), str(straight),
                  tag="straight run dp=2")
        cut = tmp_path / "cut.pt"
        run_ranks(text_cli_rank, 2, _cli(root, snap, "b", 2, every), str(cut),
                  tag="cut run dp=2")
        dcp = root / "b" / RUN / f"{RUN}_trainstate.dcp"
        assert sorted(os.listdir(dcp)) == ["2"]
        resumed = tmp_path / "resumed.pt"
        run_ranks(text_cli_rank, 2, _cli(root, snap, "c", 3, every, ["--resume", str(dcp)]),
                  str(resumed), tag="resumed run dp=2")
        a, c = torch.load(straight), torch.load(resumed)
        assert [s[0] for s in c["seen"]] == [2]
        _assert_equal_trees(a["final"], c["final"])  # bit for bit
        assert c["seen"][0][4]["count"] == 3

        # the dp = 2 state at world 1 (per_device_batch 2: the same 2-row batch)
        one = tdriver._cpu_lora(tcli.main(tcli.build_parser().parse_args(_cli(
            root, snap, "d", 3, "  per_device_batch: 2\n", ["--resume", str(dcp)]))))
        # a world-1 .pt state at dp = 2
        tcli.main(tcli.build_parser().parse_args(_cli(
            root, snap, "e", 2, "  per_device_batch: 2\n  state_checkpoint_every: 1\n")))
        pt = root / "e" / RUN / f"{RUN}_trainstate.pt"
        from_pt = tmp_path / "from_pt.pt"
        run_ranks(text_cli_rank, 2, _cli(root, snap, "f", 3, every, ["--resume", str(pt)]),
                  str(from_pt), tag="resume a .pt at dp=2")
        for other in (one, torch.load(from_pt)["final"]):
            for m, e in a["final"].items():
                for k in ("down", "up"):
                    torch.testing.assert_close(other[m][k], e[k], rtol=0, atol=1e-5)
    finally:
        torch.set_num_threads(n)
