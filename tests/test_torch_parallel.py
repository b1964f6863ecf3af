"""Data-parallel training over processes (parallel/sharding.py) on the CPU.

One 2-process gloo group runs every check (the process start-up is paid
once); this file is also the ranks' program (`python
tests/test_torch_parallel.py <work dir>`, the process group's environment
set by dist_dryrun.run_ranks), and imports JAX only in the test process,
which runs JAX's steps while the ranks run (rank 0 also takes the port's
one-process step):

- the 2-rank step (each rank its 2 rays of each 4-ray microbatch per
  modality, gradients averaged in one all-reduce) against the port's
  1-process step on the same parameters and global batch: the loss and
  metrics within rel 1e-5, each gradient group within rel-L2 1e-5;
- 4 such steps on that batch, jitter off, against JAX's single-device
  make_train_step from the same parameters: the losses within rtol 2e-3
  and every parameter within atol 1e-3 (tests/test_parallel.py's bounds);
  both ranks' parameters equal bit for bit;
- the device-cache loop (make_train_steps): every rank draws the same
  global batches, the step count advances by the 3 steps taken, the ranks
  end equal bit for bit;
- the dry run's worker (scripts/dist_dryrun_worker.py::train, the Trainer
  at n_devices = 2 on a narrow grid_raw_tpu through the kernels' plain
  versions) for 6 steps: both ranks report the same loss and end equal
  bit for bit, rank 0 alone writes config.yaml, the checkpoints and the
  eval view, and both ranks' host samplers then draw the same batch;
- the two divisibility errors and n_devices other than the world size.

The reference model is the grid method cut to CPU size (the rgb modality,
a 4-level hash grid, widths 16, 4 + 4 NeuS samples in one upsample round,
2 background samples, no jitter), float32 on both sides with no kernel;
JAX's step is compiled without LLVM's expensive passes (a shorter
compile). The JAX reference runs in the test process while the ranks run. Every collective has a 120 s
limit and a rank that fails ends the other (run_ranks).
"""

import dataclasses
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MODS = ("rgb",)
RAYS, MICRO, STEPS = 8, 4, 4
TRAINER_STEPS = 6


# --------------------------------------------------------------- the ranks


def _digest(tensors):
    import hashlib

    h = hashlib.sha256()
    for name in sorted(tensors):
        h.update(name.encode())
        h.update(tensors[name].detach().float().numpy().tobytes())
    return h.hexdigest()


def _model_and_state(inp):
    from multimodalstudio_tpu_torch.engine import train as ttrain
    from multimodalstudio_tpu_torch.models.model import MMSModel

    model = MMSModel(inp["tcfg"].model, device="cpu")
    model.load_state_dict(inp["model"])
    return model, ttrain.init_train_state(inp["tcfg"], model, inp["poses"])


def _ranks_checks(work: Path):
    from multimodalstudio_tpu_torch.data.device_cache import build_device_cache
    from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset
    from multimodalstudio_tpu_torch.engine import train as ttrain
    from multimodalstudio_tpu_torch.engine.trainer import Trainer
    from multimodalstudio_tpu_torch.parallel import sharding
    from multimodalstudio_tpu_torch.scripts import dist_dryrun_worker as worker

    dp = sharding.DataParallel.current()
    assert dp is not None and dp.world == 2
    inp = torch.load(work / "inputs.pt", weights_only=False)
    cfg = inp["tcfg"]
    cams = {m: make_synthetic_dataset(MODS, **inp["data"], device="cpu").data[m].cameras
            for m in MODS}
    out = {"rank": dp.rank}

    # one step's loss and gradients; rank 0 also takes the one-process step
    def loss_and_grads(dp):
        model, state = _model_and_state(inp)
        total, losses, metrics, grads = ttrain.batch_loss_and_grads(
            cfg, model, cams, state.camera_poses, inp["batch"], 0, ttrain.make_schedules(cfg, 0),
            None, dp)
        return {"total": total, "losses": losses, "metrics": metrics, "grads": grads}

    out["grads"] = loss_and_grads(dp)
    if dp.rank == 0:
        out["one"] = loss_and_grads(None)

    # 4 steps on that batch, jitter off
    model, state = _model_and_state(inp)
    step_fn = ttrain.make_train_step(cfg, model, cams, dp)
    out["losses"] = []
    for _ in range(STEPS):
        state, aux = step_fn(state, inp["batch"])
        out["losses"].append(float(aux["losses"]["total_loss"]))
    out["params"] = {k: p.detach().clone() for k, p in model.named_parameters()}
    out["poses"] = {k: p.detach().clone() for k, p in state.camera_poses.items()}

    # the device-cache loop: alike batches, each rank's own jitter
    model, state = _model_and_state(inp)
    state.step = 5
    cache = build_device_cache(make_synthetic_dataset(MODS, **inp["data"], device="cpu"),
                               device="cpu")
    steps = ttrain.make_train_steps(cfg, model, cams, dp)
    gen = torch.Generator().manual_seed(3)
    state, aux = steps(state, cache, gen, 3, torch.Generator().manual_seed(100 + dp.rank))
    out["cache"] = {"step": state.step, "loss": float(aux["losses"]["total_loss"]),
                    "digest": _digest(dict(model.named_parameters()))}

    # the dry run's Trainer at n_devices = 2, rank 0 alone writing; then its host sampler's
    # next batch, which every rank must draw alike (the host-sampled path's global batch)
    tcfg = dataclasses.replace(worker.tiny_config(steps=TRAINER_STEPS), n_devices=2,
                               steps_per_save=3, steps_per_eval_image=TRAINER_STEPS)
    trainer, saves = worker.train(str(work / "run"), "cpu", tcfg)
    host = {f"{m}.{f.name}": getattr(b, f.name) for m, b in trainer.sampler.sample().items()
            for f in dataclasses.fields(b)}
    out["trainer"] = {"saves": len(saves), "is_main": trainer.is_main,
                      "step": trainer.state.step, "digest": worker.params_digest(trainer),
                      "loss": float(trainer.last_aux["losses"]["total_loss"]),
                      "host_batch": _digest(host)}

    # the checks before any collective
    errors = {}
    rp = dataclasses.replace
    small = worker.tiny_config()
    for what, bad in (
            ("n_devices", rp(small, n_devices=3)),
            ("rays", rp(small, datamanager=rp(small.datamanager, num_rays_per_modality=9,
                                              microbatch_rays=0))),
            ("microbatch", rp(small, datamanager=rp(small.datamanager, num_rays_per_modality=12,
                                                    microbatch_rays=3)))):
        try:
            Trainer(bad, None, None, None, device="cpu")
            errors[what] = None
        except ValueError as e:
            errors[what] = str(e)
    out["errors"] = errors
    torch.save(out, work / f"rank{dp.rank}.pt")


def ranks_main(work: Path) -> None:
    from multimodalstudio_tpu_torch.parallel import sharding

    torch.set_num_threads(1)
    assert sharding.initialize_distributed(device="cpu")
    try:
        _ranks_checks(work)
    finally:
        torch.distributed.destroy_process_group()


# ----------------------------------------------------------- the test side


def reference_configs():
    """The JAX and port configs of the module docstring's reference model."""
    import test_torch_grid_reference as G

    def shrink(cfg, samplers):
        rp = dataclasses.replace
        m = cfg.model
        model = rp(m, modalities=tuple((k, c) for k, c in m.modalities if k in MODS),
                   ray_sampler=samplers.NeuSSamplerSpec(
                       num_samples=4, num_samples_importance=4, num_upsample_steps=1,
                       train_stratified=False),
                   background_ray_sampler=samplers.SpacedSamplerSpec(
                       num_samples=2, spacing="lin_disparity", train_stratified=False))
        return rp(cfg, model=model, modalities=MODS, max_num_iterations=40,
                  datamanager=rp(cfg.datamanager, num_rays_per_modality=RAYS,
                                 microbatch_rays=MICRO))

    jcfg, tcfg = G.configs("confs/grid.yaml", width=16)
    return shrink(jcfg, G.jsamplers), shrink(tcfg, G.tsamplers)


def carried(jcfg, tcfg):
    """Both packages on the same perturbed parameters (test_torch_grid_reference's carry
    for one modality) and a host-sampled global batch."""
    import jax

    import test_torch_grid_reference as G
    from multimodalstudio_tpu_torch.cameras.camera_optimizer import init_camera_poses
    from multimodalstudio_tpu_torch.convert import params_from_jax
    from multimodalstudio_tpu_torch.data.sampler import UniformPixelSampler
    from multimodalstudio_tpu_torch.models.model import MMSModel
    from test_torch_mlp_raw import _unflatten

    data = dict(num_views=3, height=8, width=8, raw=False)
    jds = G.jmake_dataset(MODS, **data)
    model = MMSModel(tcfg.model, device="cpu").init(torch.Generator().manual_seed(0))
    tree = _unflatten({k: v.numpy() for k, v in model.state_dict().items()})
    poses = {m: p.detach().numpy() for m, p in init_camera_poses(
        tcfg.datamanager.camera_optimizer, MODS, {m: 3 for m in MODS}, device="cpu").items()}
    params = G.perturbed({"model": tree, "camera_poses": poses})
    state = params_from_jax(jax.tree.map(np.asarray, params), model)
    model.load_state_dict(state["model"])
    tds = G.tmake_dataset(MODS, **data, device="cpu")
    batch = UniformPixelSampler(tds, RAYS, seed=7).sample()
    return dict(params=params, jds=jds, model=model, poses=state["camera_poses"], data=data,
                batch=batch, tcams={m: tds.data[m].cameras for m in MODS})


def jax_steps(jcfg, c):
    """STEPS of JAX's make_train_step on the carried parameters and batch."""
    import jax
    import jax.numpy as jnp

    import test_torch_grid_reference as G

    jbatch = {m: G.JPixelBatch(
        camera_indices=jnp.asarray(b.camera_indices.numpy().astype(np.int32)),
        pixel_coords=jnp.asarray(b.pixel_coords.numpy()), pixels=jnp.asarray(b.pixels.numpy()),
        mosaick_channel=jnp.asarray(b.mosaick_channel.numpy())) for m, b in c["batch"].items()}
    jm = G.jmodel.MMSModel(jcfg.model)
    tx = G.jtrain.make_optimizer(jcfg)
    params = jax.tree.map(lambda a: jnp.array(a, copy=True), c["params"])  # the step donates
    state = G.jtrain.TrainState(params=params, opt_state=tx.init(params), step=jnp.asarray(0))
    step = G.jtrain.make_train_step(jcfg, jm, {m: c["jds"].data[m].cameras for m in MODS})
    key = jax.random.key(2)
    step = step.lower(state, jbatch, key).compile(
        compiler_options={"xla_llvm_disable_expensive_passes": True})
    losses = []
    for _ in range(STEPS):
        state, aux = step(state, jbatch, key)
        losses.append(float(aux["losses"]["total_loss"]))
    return losses, jax.tree.map(np.asarray, state.params)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    from multimodalstudio_tpu_torch.scripts.dist_dryrun import run_ranks

    work = tmp_path_factory.mktemp("ranks")
    jcfg, tcfg = reference_configs()
    c = carried(jcfg, tcfg)
    torch.save({"tcfg": tcfg, "model": c["model"].state_dict(), "poses": c["poses"],
                "batch": c["batch"], "data": c["data"]}, work / "inputs.pt")
    env = {"PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]),
           "MMS_DIST_TIMEOUT": "120"}
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, lambda rank: [sys.executable, __file__, str(work)], 2,
                            300.0, env, str(REPO))
        jlosses, jparams = jax_steps(jcfg, c)  # while the ranks run
        done = ranks.result()
    for r, proc in enumerate(done):
        assert proc.returncode == 0, f"rank {r} failed:\n{proc.stdout[-6000:]}"
    results = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return dict(results=results, jlosses=jlosses, jparams=jparams, work=work)


def rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_two_rank_step_is_the_one_process_step(group):
    from test_torch_train import _groups

    one = group["results"][0]["one"]
    total, losses, metrics, grads = one["total"], one["losses"], one["metrics"], one["grads"]
    for res in group["results"]:
        got = res["grads"]
        assert abs(float(got["total"]) - float(total)) <= 1e-5 * abs(float(total))
        assert set(got["losses"]) == set(losses) and set(got["metrics"]) == set(metrics)
        for k in losses:
            assert abs(float(got["losses"][k]) - float(losses[k])) <= 1e-5 * abs(float(losses[k])), k
        for k in metrics:  # psnr from the all-reduced MSE, min_grad_norm a MIN
            assert abs(float(got["metrics"][k]) - float(metrics[k])) <= 1e-5 * abs(float(metrics[k])), k
        for name, keys in _groups(grads["fields"]).items():
            ref = np.concatenate([grads["fields"][k].numpy().ravel() for k in keys])
            assert np.linalg.norm(ref) > 0, name
            g = np.concatenate([got["grads"]["fields"][k].numpy().ravel() for k in keys])
            assert rel(g, ref) <= 1e-5, (name, rel(g, ref))
        for m in MODS:
            ref = grads["camera_poses"][m].numpy()
            assert rel(got["grads"]["camera_poses"][m].numpy(), ref) <= 1e-5, m


def test_four_steps_track_jaxs_single_device_step(group):
    from test_torch_mlp_raw import _flatten

    r0, r1 = group["results"]
    np.testing.assert_allclose(r0["losses"], group["jlosses"], rtol=2e-3)
    jflat = _flatten(group["jparams"]["model"])
    assert set(jflat) == set(r0["params"])
    for k, ref in jflat.items():
        np.testing.assert_allclose(r0["params"][k].numpy(), ref, atol=1e-3, err_msg=k)
    for m in MODS:
        np.testing.assert_allclose(r0["poses"][m].numpy(), group["jparams"]["camera_poses"][m],
                                   atol=1e-3)
    # both ranks took the same updates
    assert r0["losses"] == r1["losses"]
    for k in r0["params"]:
        assert torch.equal(r0["params"][k], r1["params"][k]), k
    for m in MODS:
        assert torch.equal(r0["poses"][m], r1["poses"][m])


def test_device_cache_loop_advances_and_stays_replicated(group):
    r0, r1 = (r["cache"] for r in group["results"])
    assert r0["step"] == r1["step"] == 5 + 3
    assert np.isfinite(r0["loss"]) and r0["loss"] == r1["loss"]
    assert r0["digest"] == r1["digest"]


def test_trainer_at_two_processes_writes_on_rank_0_only(group):
    r0, r1 = (r["trainer"] for r in group["results"])
    assert (r0["is_main"], r1["is_main"]) == (True, False)
    assert r0["step"] == r1["step"] == TRAINER_STEPS
    assert r0["digest"] == r1["digest"] and r0["loss"] == r1["loss"]
    # the host sampler draws one global batch on every rank
    assert r0["host_batch"] == r1["host_batch"]
    # steps 3 and 6, and the end of the run
    assert r0["saves"] == 3 and r1["saves"] == 0
    run = group["work"] / "run"
    assert (run / "config.yaml").exists()
    assert sorted(os.listdir(run / "checkpoints")) == [f"step-{TRAINER_STEPS:09d}.pt"]
    assert (run / "renders").is_dir()


def test_divisibility_and_world_size_errors(group):
    for res in group["results"]:
        e = res["errors"]
        assert e["n_devices"] and "n_devices=3" in e["n_devices"] and "2 processes" in e["n_devices"]
        assert e["rays"] and "num_rays_per_modality=9 must divide n_devices=2" in e["rays"]
        assert e["microbatch"] and "microbatch_rays=3 must divide n_devices=2" in e["microbatch"]


def test_dryrun_worker_ranks_agree(group):
    """The dry run's worker trained in the group: both ranks report the same loss (and
    parameters, the digest dist_dryrun.py compares)."""
    r0, r1 = (r["trainer"] for r in group["results"])
    assert np.isfinite(r0["loss"]) and (r0["loss"], r0["digest"]) == (r1["loss"], r1["digest"])


def test_a_rank_that_fails_ends_the_others(tmp_path):
    import time

    from multimodalstudio_tpu_torch.scripts.dist_dryrun import run_ranks

    # rank 1 fails only once rank 0 has printed: on a loaded host rank 0 could
    # otherwise be killed before its first line
    ready = str(tmp_path / "rank0_printed")
    code = f"""import os, sys, time
r = int(os.environ['MMS_PROCESS_ID'])
print('rank', r, os.environ['MMS_NUM_PROCESSES'], flush=True)
if r == 0:
    open({ready!r}, 'w').close()
    time.sleep(60)
while not os.path.exists({ready!r}):
    time.sleep(0.01)
sys.exit(3)
"""
    t0 = time.monotonic()
    done = run_ranks(lambda rank: [sys.executable, "-c", code], 2, 50.0)
    assert time.monotonic() - t0 < 30
    assert done[1].returncode == 3 and done[0].returncode != 0
    assert done[0].stdout.startswith("rank 0 2") and done[1].stdout.startswith("rank 1 2")


def test_shard_batch_takes_each_ranks_rows():
    """Without a group: rank r of 2 takes rows [r n / 2, (r + 1) n / 2) of every leaf of
    every modality; a batch that does not split raises."""
    from multimodalstudio_tpu_torch.data.sampler import PixelBatch
    from multimodalstudio_tpu_torch.parallel import sharding

    rng = np.random.default_rng(0)
    batch = {m: PixelBatch(torch.arange(6), torch.from_numpy(rng.random((6, 2), np.float32)),
                           torch.from_numpy(rng.random((6, 3), np.float32)),
                           torch.arange(6, dtype=torch.int32)) for m in ("rgb", "mono")}
    assert sharding.shard_batch(batch, None) is batch
    for rank in range(2):
        got = sharding.shard_batch(batch, sharding.DataParallel(rank, 2))
        for m, b in got.items():
            for f in dataclasses.fields(b):
                assert torch.equal(getattr(b, f.name), getattr(batch[m], f.name)[3 * rank:3 * rank + 3])
    with pytest.raises(ValueError, match="do not split"):
        sharding.shard_batch(batch, sharding.DataParallel(0, 4))
    assert sharding.world_size() == 1 and sharding.is_main_process()
    assert sharding.DataParallel.current() is None


if __name__ == "__main__":
    ranks_main(Path(sys.argv[1]))
