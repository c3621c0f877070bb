"""The plain reference against the program's plain path on the CPU, at tiny
widths: both models' forwards; one flow-matching and one DDPM train step
(loss, gradients, the AdamW update); two flowmatch Euler and two
DPM-Solver++ steps of a 50-step schedule."""

import numpy as np
import pytest
import torch

from benchmark import build, compare, counters
from benchmark.reference import sampling, training
from benchmark.reference.ops import Ops, fp8_round
from benchmark.tests.tiny import REPO, TINY_UNETS

torch.set_num_threads(2)


def tiny_cfg(name):
    import json

    base, unet, spatial = TINY_UNETS[name]
    cfg = json.loads((REPO / "benchmark" / "configs" / f"{base}.json").read_text())
    cfg["model"]["unet"].update(unet)
    cfg["spatial"] = spatial
    return cfg


def both(name, seed=0):
    """(program model, reference model) with the same random weights, f32, CPU."""
    cfg = tiny_cfg(name)
    weights = build.weights(cfg, seed, "cpu")
    return cfg, build.program_model(cfg, weights, "cpu"), build.reference_model(cfg, weights,
                                                                                  "cpu")


def inputs(cfg, batch=2, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, cfg["in_channels"], *cfg["spatial"]), generator=g)
    return x, g


@pytest.mark.parametrize("name", ["tiny2d", "tiny3d"])
def test_forward_matches_program(name):
    cfg, prog, ref = both(name)
    x, _ = inputs(cfg)
    t = torch.tensor([7, 901])
    with torch.no_grad():
        got, want = prog(x, t), ref(x, t)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_state_dict_names_match_the_program_at_published_widths():
    from fmdm_tpu_torch.models.factories import DiffusionUNetFactory

    for cfg_name, params in (("ldct_unet2d_flow", 113_669_761),
                             ("volume3d_efficientunet", 42_017_537)):
        import json

        cfg = json.loads((REPO / "benchmark" / "configs" / f"{cfg_name}.json").read_text())
        prog = DiffusionUNetFactory().build(cfg["model"]["unet"], conditioning="concatenate",
                                            channels=1, device="meta")
        shapes = build.weight_shapes(cfg)
        assert shapes == {k: tuple(v.shape) for k, v in prog.state_dict().items()}
        assert sum(int(np.prod(s)) for s in shapes.values()) == params == cfg["parameters"]


@pytest.mark.parametrize("name,variant", [("tiny2d", "flow_matching"), ("tiny3d", "diffusion")])
def test_train_step_matches_program(name, variant):
    from fmdm_tpu_torch.schedulers.registry import build_scheduler
    from fmdm_tpu_torch.train.common import make_adamw, make_denoise_train_step

    cfg, prog, ref = both(name)
    opt = cfg["optimizer"]
    x, g = inputs(cfg, batch=3)
    x0, cond = x[:, :1], x[:, 1:]
    noise = torch.randn(x0.shape, generator=g)
    t = (torch.randint(0, 1000, (3,), generator=g) if variant == "diffusion"
         else torch.rand((3,), generator=g))
    scheduler, _ = build_scheduler({"name": "ddpm", "num_train_timesteps": 1000}, {})
    optimizer, rate = make_adamw(prog.parameters(), opt["learning_rate"], opt["weight_decay"],
                                 opt["lr_warmup_steps"], opt["num_training_steps"])
    step = make_denoise_train_step(prog, scheduler, optimizer, rate, variant=variant,
                                   conditioning_mode="concatenate", latent_norm=None,
                                   device="cpu")
    step.global_step = opt["start_step"]
    start = {k: v.detach().clone() for k, v in prog.named_parameters()}
    loss_sum, count = step.step({"target": x0, "image": cond, "valid": torch.ones(3)},
                                noise=noise, t=t)
    got_grads = {k: p.grad.clone() for k, p in prog.named_parameters()}
    out = training.train_steps(ref, variant, [{"x0": x0, "cond": cond, "noise": noise, "t": t}],
                               base_lr=opt["learning_rate"], weight_decay=opt["weight_decay"],
                               warmup=opt["lr_warmup_steps"], total=opt["num_training_steps"],
                               start_step=opt["start_step"])
    assert abs(float(loss_sum / count) - out["losses"][0]) <= 1e-5 * out["losses"][0]
    med = training.median(out["first_grad"].values())
    for name_, p in ref.named_parameters():
        assert float((got_grads[name_] - p.grad).norm()) <= 1e-4 * max(out["first_grad"][name_],
                                                                        med)
    # the reference's AdamW on the program's gradient gives the program's update
    shadow = {k: torch.nn.Parameter(v.clone()) for k, v in start.items()}
    for k, v in shadow.items():
        v.grad = got_grads[k]
    training.AdamW(shadow, opt["weight_decay"]).step(
        training.cosine_rate(opt["start_step"], opt["learning_rate"], opt["lr_warmup_steps"],
                             opt["num_training_steps"]))
    for k, p in prog.named_parameters():
        assert float((p.detach() - shadow[k].detach()).abs().max()) <= 1e-3 * opt["learning_rate"]


@pytest.mark.parametrize("name,spec,sampler", [
    ("tiny2d", {"name": "flowmatch", "num_train_timesteps": 1000}, "flow_euler"),
    ("tiny3d", {"name": "dpm_multistep", "num_train_timesteps": 1000,
                "params": {"solver_order": 2, "algorithm_type": "dpmsolver++"}},
     "dpm_solver_pp2")])
def test_two_sampling_steps_match_program(name, spec, sampler):
    from fmdm_tpu_torch.schedulers.registry import build_scheduler

    cfg, prog, ref = both(name)
    x, _ = inputs(cfg)
    noise, cond = x[:, :1], x[:, 1:]
    scheduler, _ = build_scheduler(spec, {})
    ts = scheduler.set_timesteps(50)
    state, cur = scheduler.init_state(ts, noise), noise
    int_t = np.issubdtype(ts.dtype, np.integer)
    with torch.no_grad():
        for i in range(2):
            tt = torch.full((2,), ts[i].item(), dtype=torch.int32 if int_t else torch.float32)
            pred = prog(torch.cat([cur, cond], dim=1), tt)
            state, cur = scheduler.step(state, pred, i, cur, ts)
    want = sampling.SAMPLERS[sampler](ref, noise, cond, 50, stop=2)
    assert float((cur - want).abs().max() / want.abs().max()) < 1e-5


def test_fp8_round_is_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(3))
    e8 = float((fp8_round(x) - x).norm() / x.norm())
    e16 = float((x.bfloat16().float() - x).norm() / x.norm())
    assert 8 * e16 < e8 < 0.05


def test_control_fails_where_the_program_passes():
    """At a size a test run holds: the fp8 reference put in the program's
    place fails the tiny train cell's limits and the sample cell's, the
    program's bf16 passes them (the cells' own limits were set the same way
    from chip readings at their sizes)."""
    from benchmark.tests.tiny import TINY_LIMITS, tiny_root

    import tempfile
    from pathlib import Path

    from benchmark import harness

    with tempfile.TemporaryDirectory() as tmp:
        root = tiny_root(Path(tmp))
        bench = harness.Bench(root)
        for cell_name in ("tiny2d_train", "tiny3d_sample"):
            cell = bench.cell(cell_name)
            cfg = bench.config(cell["config"])
            entry = bench.entry(cell["entry"])(cfg, cell, 4_000_000_321, "cpu")
            entry.setup()
            if entry.kind == "sample":
                entry.window(units=1)
            entry.release()
            limits = TINY_LIMITS[entry.kind]
            if entry.kind == "train":
                ref = entry.reference_readings()
                prog = compare.train_numbers(entry.readings, ref)
                ctrl = compare.train_numbers(entry.reference_readings("fp8"), ref)
            else:
                call, rows = entry.judged()
                ref = entry.reference_rows(call, rows)
                prog = compare.sample_numbers(entry.calls[call][2][rows], ref)
                ctrl = compare.sample_numbers(entry.reference_rows(call, rows, "fp8"), ref)
            assert all(c.ok for c in compare.checks(prog, limits)), prog
            assert not all(c.ok for c in compare.checks(ctrl, limits)), ctrl
