"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions, and builds every CUDA kernel of the port with nvcc.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes the grid_raw_tpu eval path gives it (per 1024-ray chunk), and
   times kernel, plain version and, where one exists, a PyTorch call that
   computes the same function (CUDA events, median of 15 after warm-up).
   Then checks the cases that path does not reach (ragged N, skip layers,
   truncated and masked grids).
3. Renders one eval view of every modality of a raw 5-modality synthetic
   scene (256 x 256, 10 views) through RawEvaluator at full grid_raw_tpu
   width with seeded random weights, scores it, checks that the render went
   through every kernel (launch counts), and renders one chunk again on the
   CPU through the plain versions for comparison.

Prints one {"kernels": [...]} line, and last the {"ok": true, "device":
...} line. Exits non-zero, printing no result, when a phase fails or no
card is present.
"""

import json
import statistics
import subprocess
import sys
import time

import torch

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_BYTES = 3.35e12  # HBM3 bandwidth, H100 SXM data sheet
SEED = 0
REPS = 15


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Median milliseconds of one call, CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, n_bytes: float):
    t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, n_bytes / H100_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (or lists of tensors), each counted once."""
    return sum(nbytes(*t) if isinstance(t, (list, tuple)) else t.numel() * t.element_size()
               for t in tensors)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def random_chain(gen, dims, dev):
    ws = [torch.randn(din, dout, generator=gen, device=dev) / din**0.5 for din, dout in dims]
    bs = [0.1 * torch.randn(dout, generator=gen, device=dev) for _, dout in dims]
    return ws, bs


def check_fused_chain(gen, dev):
    """K1 at the five chain shapes of one 1024-ray chunk."""
    import torch.nn.functional as F

    from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import fused_chain, fused_chain_plain

    shapes = [  # (name, N, dims, activation)
        ("radiance trunk", 65536, [(285, 256), (256, 256), (256, 256)], "ReLU"),
        ("polarization head", 65536, [(256, 256), (256, 256), (256, 3)], "ReLU"),
        ("background base", 16384, [(39, 256), (256, 256), (256, 256), (256, 256)], "ReLU"),
        ("background head", 16384, [(283, 128), (128, 128), (128, 128), (128, 128)], "ReLU"),
        ("background polarization head", 16384, [(128, 256), (256, 256), (256, 3)], "ReLU"),
    ]
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0, err=0.0)
    for name, n, dims, act in shapes:
        ws, bs = random_chain(gen, dims, dev)
        x = torch.rand(n, dims[0][0], generator=gen, device=dev) * 2 - 1
        y = fused_chain(x, ws, bs, activation=act)
        ref = fused_chain_plain(x, ws, bs, activation=act)
        torch.cuda.synchronize()
        err = float((y.float() - ref.float()).abs().max())
        rel = rel_l2(y.float(), ref.float())
        print(f"  K1 {name}: N={n} rel_l2={rel:.3e} max_abs={err:.3e} (tolerance rel_l2 <= 1e-2)")
        if not rel <= 1e-2:
            fail(f"fused_chain disagrees with its plain version at {name}")
        wb = [w.t().contiguous().to(torch.bfloat16) for w in ws]
        xb = x.to(torch.bfloat16)

        def library():
            h = xb
            for l, (w, b) in enumerate(zip(wb, bs)):
                h = F.linear(h, w, b.to(torch.bfloat16))
                if l < len(wb) - 1:
                    h = torch.relu(h)
            return h

        tot["ms"] += time_ms(lambda: fused_chain(x, ws, bs, activation=act))
        tot["plain_ms"] += time_ms(lambda: fused_chain_plain(x, ws, bs, activation=act))
        tot["library_ms"] += time_ms(library)
        tot["flops"] += 2.0 * n * sum(a * b for a, b in dims)
        tot["bytes"] += nbytes(x, ws, bs, y)
        tot["err"] = max(tot["err"], err)
    return tot


def slot_inputs(gen, dev, gspec):
    from multimodalstudio_tpu_torch.ops.kernels.slot_grid import make_table_init

    # the table init is uniform +-1e-4, which would hide gather faults: scale it up
    table = make_table_init(gspec)(gen) * 1e4
    ws, bs = random_chain(gen, [(51, 128), (128, 128), (128, 257)], dev)
    return table, ws, bs


SLOT_KW = dict(radius=1.0, num_frequencies=6, min_freq_exp=0.0, max_freq_exp=5.0,
               activation="SoftplusQuad", beta=100.0)


def check_slot_value(gen, dev, gspec):
    """K2 at one chunk's sampler queries: N=32768 then 3 x 8192, 4 levels."""
    from multimodalstudio_tpu_torch.ops.kernels.slot_fused import (
        fused_slot_sdf_value,
        slot_sdf_value_plain,
    )

    table, ws, bs = slot_inputs(gen, dev, gspec)
    k = 4
    mask = torch.ones(k * gspec.feats, device=dev)
    tot = dict(ms=0.0, plain_ms=0.0, flops=0.0, bytes=0.0, err=0.0)
    for n, count in ((32768, 1), (8192, 3)):
        pos = torch.rand(n, 3, generator=gen, device=dev) * 2.2 - 1.1
        args = (pos, table, ws, bs, gspec)
        kw = dict(SLOT_KW, level_mask=mask, num_levels=k)
        sdf = fused_slot_sdf_value(*args, **kw)
        ref = slot_sdf_value_plain(*args, **kw)
        torch.cuda.synchronize()
        err = float((sdf - ref).abs().max())
        rel = rel_l2(sdf, ref)
        print(f"  K2 N={n}: rel_l2={rel:.3e} max_abs={err:.3e} (tolerance rel_l2 <= 1e-2)")
        if not (rel <= 1e-2 and torch.isfinite(sdf).all()):
            fail("fused_slot_sdf_value disagrees with its plain version")
        tot["ms"] += count * time_ms(lambda: fused_slot_sdf_value(*args, **kw))
        tot["plain_ms"] += count * time_ms(lambda: slot_sdf_value_plain(*args, **kw))
        # sdf needs column 0 of the last layer only
        tot["flops"] += count * 2.0 * n * (51 * 128 + 128 * 128 + 128 * 1)
        tot["bytes"] += count * nbytes(pos, table, mask, ws, bs, sdf)
        tot["err"] = max(tot["err"], err)
    return tot


def check_slot_chain(gen, dev, gspec):
    """K3 at one chunk's render samples: N=65536, all 6 levels."""
    from multimodalstudio_tpu_torch.ops.kernels.slot_fused import (
        fused_slot_sdf_chain,
        slot_sdf_chain_plain,
    )

    table, ws, bs = slot_inputs(gen, dev, gspec)
    n = 65536
    pos = torch.rand(n, 3, generator=gen, device=dev) * 2.2 - 1.1
    mask = torch.ones(gspec.out_dim, device=dev)
    args = (pos, table, ws, bs, gspec)
    kw = dict(SLOT_KW, level_mask=mask)
    out = fused_slot_sdf_chain(*args, **kw)
    ref = slot_sdf_chain_plain(*args, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("sdf", "geo", "grad"), out, ref):
        rel = rel_l2(a.float(), b.float())
        e = float((a.float() - b.float()).abs().max())
        err = max(err, e)
        print(f"  K3 {name}: rel_l2={rel:.3e} max_abs={e:.3e} (tolerance rel_l2 <= 1e-2)")
        if not (rel <= 1e-2 and torch.isfinite(a.float()).all()):
            fail(f"fused_slot_sdf_chain disagrees with its plain version on {name}")
    flops = 2.0 * n * (51 * 128 + 128 * 128 + 128 * 257) + 2.0 * n * (128 * 128 + 128 * 51)
    return dict(ms=time_ms(lambda: fused_slot_sdf_chain(*args, **kw)),
                plain_ms=time_ms(lambda: slot_sdf_chain_plain(*args, **kw)),
                flops=flops, bytes=nbytes(pos, table, mask, ws, bs, out), err=err)


def check_edge_cases(gen, dev, gspec) -> None:
    """Cases the main path does not give the kernels: a ragged N, a skip
    layer, the None activation, level truncation with a partial mask."""
    from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import fused_chain, fused_chain_plain
    from multimodalstudio_tpu_torch.ops.kernels.slot_fused import (
        fused_slot_sdf_chain,
        fused_slot_sdf_value,
        slot_sdf_chain_plain,
        slot_sdf_value_plain,
    )

    n = 1000  # not a multiple of the 64-sample tile
    chains = (("SoftplusQuad", (2,), [(39, 128), (128, 128), (167, 128), (128, 17)]),
              ("None", (), [(39, 128), (128, 5)]))
    for act, skip, dims in chains:
        ws, bs = random_chain(gen, dims, dev)
        x = torch.rand(n, 39, generator=gen, device=dev) * 2 - 1
        rel = rel_l2(fused_chain(x, ws, bs, skip=skip, activation=act).float(),
                     fused_chain_plain(x, ws, bs, skip=skip, activation=act).float())
        print(f"  K1 {act} skip={skip} N={n}: rel_l2={rel:.3e} (tolerance rel_l2 <= 1e-2)")
        if not rel <= 1e-2:
            fail(f"fused_chain disagrees with its plain version ({act}, skip {skip})")
    table, ws, bs = slot_inputs(gen, dev, gspec)
    pos = torch.rand(n, 3, generator=gen, device=dev) * 2.2 - 1.1
    feats = gspec.feats
    mask = (torch.arange(3 * feats, device=dev) < 2 * feats).float()
    kw = dict(SLOT_KW, level_mask=mask, num_levels=3)
    rel = rel_l2(fused_slot_sdf_value(pos, table, ws, bs, gspec, **kw),
                 slot_sdf_value_plain(pos, table, ws, bs, gspec, **kw))
    print(f"  K2 3 levels, 2 active, N={n}: rel_l2={rel:.3e} (tolerance rel_l2 <= 1e-2)")
    if not rel <= 1e-2:
        fail("fused_slot_sdf_value disagrees with its plain version on a truncated grid")
    mask = (torch.arange(gspec.out_dim, device=dev) < 4 * feats).float()
    kw = dict(SLOT_KW, level_mask=mask)
    out = fused_slot_sdf_chain(pos, table, ws, bs, gspec, **kw)
    ref = slot_sdf_chain_plain(pos, table, ws, bs, gspec, **kw)
    for name, a, b in zip(("sdf", "geo", "grad"), out, ref):
        rel = rel_l2(a.float(), b.float())
        print(f"  K3 4 of 6 levels active, N={n}, {name}: rel_l2={rel:.3e} "
              "(tolerance rel_l2 <= 1e-2)")
        if not rel <= 1e-2:
            fail(f"fused_slot_sdf_chain disagrees with its plain version on {name} (masked)")


def run_slice(dev, card):
    """Render one eval view of every modality through the port's
    RawEvaluator and check outputs, launch counts and a CPU re-render."""
    import dataclasses

    import numpy as np

    from multimodalstudio_tpu_torch.cameras.camera_optimizer import init_camera_poses
    from multimodalstudio_tpu_torch.configs.methods import FIVE_MODALITIES, method_configs
    from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset
    from multimodalstudio_tpu_torch.engine.evaluator import RawEvaluator
    from multimodalstudio_tpu_torch.engine.train import TrainState
    from multimodalstudio_tpu_torch.models.model import MMSModel
    from multimodalstudio_tpu_torch.ops.kernels import build

    cfg = method_configs()["grid_raw_tpu"]
    cfg = dataclasses.replace(cfg, modalities=FIVE_MODALITIES)
    dataset = make_synthetic_dataset(FIVE_MODALITIES, num_views=10, height=256, width=256,
                                     raw=True, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = MMSModel(cfg.model, device=dev).init(gen)
    num_cameras = {m: dataset.data[m].cameras.camera_to_worlds.shape[0] for m in FIVE_MODALITIES}
    poses = init_camera_poses(cfg.datamanager.camera_optimizer, FIVE_MODALITIES, num_cameras,
                              device=dev)
    state = TrainState(camera_poses=poses, step=cfg.max_num_iterations)
    evaluator = RawEvaluator(cfg, model, dataset, dataset, device=dev)
    chunk = cfg.evaluator.eval_num_rays_per_chunk

    evaluator.render_view(state, dataset, "rgb", 0)  # warm-up
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    frames = {m: evaluator.render_view(state, dataset, m, 0) for m in FIVE_MODALITIES}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: info.launches for name, info in build.KERNELS.items()}

    n_rays = sum(f["accumulation"].shape[0] * f["accumulation"].shape[1] for f in frames.values())
    chunks = sum(-(-f["accumulation"].size // chunk) for f in frames.values())
    for mod, f in frames.items():
        for key, val in f.items():
            if not np.all(np.isfinite(val)):
                fail(f"non-finite {key} in the {mod} render")
        acc = f["accumulation"]
        if acc.min() < 0.0 or acc.max() > 1.0 + 1e-6:
            fail(f"accumulation outside [0, 1] in the {mod} render")
        metrics = evaluator.view_metrics(f, mod)
        print(f"  {mod}: {f[mod].shape} " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
        if not all(np.isfinite(v) for v in metrics.values()):
            fail(f"non-finite metrics for {mod}")
    want = {"fused_chain": 5 * chunks, "fused_slot_sdf_value": 4 * chunks,
            "fused_slot_sdf_chain": chunks}
    print(f"  launches {launches}, expected {want} for {chunks} chunks")
    if launches != want:
        fail("the render did not go through every kernel as often as expected")
    print(f"  rendered {n_rays} rays in {seconds:.3f} s: {n_rays / seconds:.1f} rays/s "
          f"(eval, grid_raw_tpu, 5 modalities, {card})")

    # one chunk again on the CPU through the plain versions
    cpu_model = MMSModel(cfg.model, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_eval = RawEvaluator(cfg, cpu_model, dataset, dataset, device="cpu")
    from multimodalstudio_tpu_torch.data.sampler import dense_pixel_batch

    batch = dense_pixel_batch(dataset, "rgb", 0, cfg.evaluator.rendering_scale)
    cams = dataset.data["rgb"].cameras
    idx, coords = batch.camera_indices[:chunk], batch.pixel_coords[:chunk]
    gpu_out = evaluator._render_chunk(state, "rgb", cams, idx, coords)
    cpu_cams = dataclasses.replace(cams, **{
        k: getattr(cams, k).cpu() for k in ("fx", "fy", "cx", "cy", "camera_to_worlds")
    })
    cpu_state = TrainState(camera_poses={m: p.cpu() for m, p in poses.items()}, step=state.step)
    cpu_out = cpu_eval._render_chunk(cpu_state, "rgb", cpu_cams, idx.cpu(), coords.cpu())
    worst = 0.0
    for key, ref in cpu_out.items():
        rel = rel_l2(gpu_out[key].float().cpu(), ref.float())
        worst = max(worst, rel)
        print(f"  chunk vs CPU plain: {key} rel_l2={rel:.3e}")
    # importance samples can move with bf16 noise between the two, so loose
    if not worst <= 5e-2:
        fail("the card's render disagrees with the CPU plain render (rel_l2 > 5e-2)")
    profile_render(evaluator, state, dataset, 1e3 * seconds / len(frames))
    return launches, n_rays / seconds


def profile_render(evaluator, state, dataset, view_ms: float) -> None:
    """Device time by kernel over one rgb view render (torch.profiler), and
    the share of the render's wall time the card was busy, under the
    profiler and against an unprofiled view's mean time `view_ms`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluator.render_view(state, dataset, "rgb", 0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's device time repeats its kernels'
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(r[0] for r in rows)
    print(f"  profile of one rgb view: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%; {100 * busy_ms / view_ms:.1f}% of an unprofiled "
          f"view's {view_ms:.2f} ms), {sum(r[1] for r in rows)} device ops")
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        print(f"    {ms:9.3f} ms {count:6d}x {key[:90]}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    from multimodalstudio_tpu_torch.device import set_reference_precision
    from multimodalstudio_tpu_torch.ops.kernels import build
    from multimodalstudio_tpu_torch.ops.kernels.slot_grid import SlotGridSpec

    set_reference_precision()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}")
    print(f"built kernels in {build.build_all():.1f} s")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gspec = SlotGridSpec(num_levels=6, min_res=16, max_res=512, rows_per_level=4096,
                         layout="cell", feats=2, table_dtype="bf16")
    print("kernel checks (per 1024-ray chunk):")
    results = {
        "fused_chain": check_fused_chain(gen, dev),
        "fused_slot_sdf_value": check_slot_value(gen, dev, gspec),
        "fused_slot_sdf_chain": check_slot_chain(gen, dev, gspec),
    }
    print("kernel checks off the main path's shapes:")
    check_edge_cases(gen, dev, gspec)
    print("render:")
    launches, rays_per_s = run_slice(dev, card)

    entries = []
    for name, r in results.items():
        info = build.KERNELS[name]
        b_ms, b_by = bound(r["flops"], r["bytes"])
        entries.append({
            "name": name, "route": "cuda", "source": info.source, "replaces": info.replaces,
            "launches": launches[name], "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": r.get("library_ms"),
        })
    print(f"eval rays/s {rays_per_s:.1f} ({card})")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
