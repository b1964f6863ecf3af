"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions, and builds every CUDA kernel of the port with nvcc.
2. Holds each forward kernel against its plain PyTorch version on the card
   at the shapes an eval path gives it (per 1024-ray chunk), and each
   backward kernel against its plain backward at the shapes one training
   microbatch gives it (512 rays per modality), and times kernel, plain
   version and a PyTorch call (or composition) that computes the same
   function, where one exists (CUDA events, median of 15 after warm-up):
   K1-K3 at the grid_raw_tpu shapes (K1's backward also in its parts: the
   pack of its weight images against its plain version bit for bit, the
   per-tile pass and chain_wgrad against theirs, each K1 check printing the
   kernel's time alone and the device ops of one wrapper call beside the
   wrapper's time), K4 at the mlp_raw_tpu ones, K1 at the
   8-layer mlp_raw_tpu chains, K6 and K5 at the shapes of grid_raw_tpu
   without its position encoding, K1t and K4j (the forward-tangent
   chains) at the mlp_raw_tpu SDF chain's, and the split backward's
   kernels (K2s and K3s, the per-sample passes, and the table scatter) at
   grid_raw_tpu's, where the whole split backward is also held against the
   merged backward kernels and timed beside them; then the same slot
   kernels with an f32 table (K2f, K3f, their merged and split backwards
   and the f32 scatter) at the shapes of grid_raw_tpu with an f32 table
   (6 levels of 512 entries, F = 16). Then checks the cases those paths
   do not reach (ragged N, skip layers, ReLU, truncated and masked grids,
   one or two tangents, the full tangent output, 10-layer chains, 9 and 16
   grid levels, the slot kernels with a skip on either table and on a
   10-layer chain whose stacks live in device scratch). Then K6 with the
   f32 table's cell grid (6 x 512 entries, F = 16) and K6v, the vertex
   layout's lookup, at the shapes of grid_raw_tpu without its position
   encoding on a vertex table (6 x 2048 rows, F = 16, f32), each within
   rel-L2 1e-4 of its plain version (both exact f32), with a ragged N and
   3 levels off those shapes (K6's edge cases also at F = 4 and 8). Then
   K5 and K1 on that label's SDF head (99 -> 128 -> 128 -> 257): K5
   forward at the render samples of a chunk and of a microbatch and
   backward at a microbatch's, K1 forward at the
   sampler's queries and the taps and backward at the taps, the SoftplusQuad
   backwards' limits following the plain version's spread. Then hidden
   widths 384 and 512, and 640, 768 and 1024: K1 forward and backward and
   the K4, K5, K1t and K4j forwards and backwards, past 512 also K2's and
   K3's forwards and backwards, merged and split, on both tables, each
   against its plain version, and every one bit for bit against the
   512-wide kernel on chains padded with dead units. Then K6v again at
   positions ordered as the sampler emits them (512 rays of 320 sorted
   samples through the unit cube, and their curvature taps), forward and
   backward with one and with three active levels, each within 1e-4 of its
   plain version, its wrapper and kernel-alone ms printed beside the
   uniform draw's (which, as K6's, print the kernel alone and the device
   ops of a call too); then K6 the same way on grid_raw_tpu's bf16 cell
   table (within 1e-2), and the split's table scatter, bf16 and f32
   tables, on K3s's and K2s's own table cotangents at those render samples
   and their taps with one active level, each within 1e-2 of its plain
   version and each whole split backward against the merged backward
   kernel there at the JAX test's limits, the scatter's wrapper and
   kernel-alone ms printed beside its bound. K3's backward checks
   also run at positions ordered as the sampler emits them (rays of
   consecutive samples) and print the pass's and chain_wgrad's time alone,
   the device ops of a call and the table reductions issued. The forward
   checks (K1's, K2's and the adjoint and tangent forwards of K3, K4, K5,
   K1t and K4j) and K2's backward print the kernel alone and the device ops
   of one wrapper call beside the wrapper's time; every backward is timed
   on its forward's images, as the main path runs it.
3. For grid_raw_tpu, mlp_raw_tpu, grid_raw_tpu with
   model.surface.surface_field.use_position_encoding = False (through
   load_config's overrides: its SDF runs the slot-grid lookup K6 and the
   chain adjoint K5), mlp_raw_tpu with model.surface.contraction_order =
   inf (its render samples run K1t), mlp_raw_tpu with
   MMS_SDF_CHAIN_MODE=jvp (K4j), grid_raw_tpu with MMS_SLOT_BWD_SPLIT=1
   (the split backward), and grid_raw_tpu with the slot grid of the
   committed capacity_base6 checkpoint (rows_per_level = 512, feats = 16,
   table_dtype = "f32" through load_config: K2f and K3f), merged and under
   MMS_SLOT_BWD_SPLIT=1, and grid_raw_tpu without its position encoding on
   the vertex layout's table (layout = "vertex", rows_per_level = 2048,
   feats = 16, table_dtype = "f32": K6v in K6's place, K6 never launched),
   at full width with seeded random weights
   on a raw 5-modality synthetic scene (256 x 256, 10 views):
   renders one eval view of every modality through RawEvaluator (the f32
   split label reports the f32 label's render: a render runs no backward),
   scores it,
   checks that the render went through its forward kernels (exact launch
   counts) and renders one chunk again on the CPU through the plain
   versions; then trains at the bench geometry (2048 rays per modality in 4
   microbatches of 512, sampled on the card; 2 warm-up steps, then 5 timed
   steps), checks finite losses and gradients, that every parameter moved
   in one of the steps and the exact launches of every step, prints train
   rays/s, profiles one step, and compares one 64-ray-per-modality
   microbatch's loss and gradients with the same microbatch through the
   plain versions on the CPU. On the contraction path it also holds the K1t route against the K4
   route of mlp_raw_tpu on one microbatch's render samples inside the unit
   cube, where the contraction is the identity.
   Then the same for the reference methods, which launch no kernel of the
   port (REFERENCE_LABELS: float32 unfused MLPs with TF32 off, the plain
   hash grid of 16 levels x 2^19 entries, remat): grid_raw and mlp_raw
   through confs/grid_raw.yaml and confs/mlp_raw.yaml, grid through
   confs/grid.yaml on a demosaicked scene through Evaluator, and
   grid_raw_grid_bg_unbalanced (a hash-grid background) from the registry
   with 512-ray microbatches. Each must launch no kernel; its render chunk
   must agree with the CPU's within rel-L2 1e-3, and its microbatch's loss
   and every gradient group within max(1e-3, twice the CPU run's distance
   to itself with its parameters moved by 1e-6; 5e-2 for the camera poses,
   POSE_TOL); each prints the peak device memory of its timed steps, the
   share of the profiled step's busy time in index_select's and
   index_add_'s kernels, and each of its hash grids timed alone, forward
   and backward, at a microbatch's largest call.

4. Then the trained checkpoints and the port's entry points. (A) For
   each committed rehearsal run of rehearsals.py (rehearsal_mlp_dense and
   rehearsal_grid_dense at step 99999, rehearsal_grid_packed_confirm at
   62499; their weights files, converted on the CPU by
   convert_checkpoints.py, beside the orbax directories): the config
   through load_config with a dict of the leaves its confs/*.yaml sets,
   the 36-view, 256 x 256 raw scene through launcher.build_datasets, the
   weights through engine/checkpoints.py; every kernel call of view 0's
   central 4096-ray eval chunk (through the sphere) held against its
   plain version on the trained inputs; then
   RawEvaluator.render_all_eval_views at rendering_scale 1.0 (every eval
   view, 7 per modality), exact launch counts, rays/s, each modality's
   metrics beside the run's results.txt block (the JAX package's eval of
   the same weights; it fails when a mosaicked PSNR falls more than 1.0 dB
   below it, or, for packed_confirm, whose file is 2500 steps past its
   last block, under 30 dB) and each view's mosaicked PSNR. Then,
   uncounted, for the two runs results.txt scores at their checkpoint's
   step: every view again through the plain versions on the card (it
   fails when a modality's PSNR through the kernels is more than 1.0 dB
   below it). (B) export_mesh of
   rehearsal_grid_dense at 256^3: its first SDF chunk against K2f's plain
   version, one K2f launch a 262,144-point chunk, and the median radial
   error against the scene's sphere of radius 0.5, at most 2 grid
   spacings. (C) grid_raw_tpu at full width on
   synthetic_raw:views=12,size=96 in a temporary directory: launcher
   --mode train for 10 steps (a whole-state checkpoint), a Trainer whose
   every cadence fires once in 20 steps resuming from it, then launcher
   --mode eval; the resumed steps and the files written.

5. (D) A scene from disk: synthetic_raw:views=12,size=96's raw 5-modality
   scene written as 16-bit PNGs and meta_data.json by the port's
   write_synthetic_scene into a temporary directory, loaded through
   launcher.build_datasets (the port's PNG reader; the card's machine has
   no OpenCV), every frame within one 16-bit step of the in-memory scene
   and the cameras and masks equal; the host's decode of a 2048² 16-bit
   frame with Sub rows (as cv2 writes) and with all five filters (the
   anti-diagonal wavefront); launcher --mode train for 10 steps on
   the directory, then --mode eval, K1, K2 and K3 launched; then the
   bench-geometry training of step 3 on the disk scene's frames (rays/s,
   busy ms a step). Then, as in step 3, VOLSDF_LABEL: grid_raw_tpu with
   VolSDF, the box collider, random background colours in place of the
   background field, and the fields group on RAdam, the camera poses on
   Adam (the colours injected alike on the card and the CPU for the
   comparisons), its view rendered once more with the near_far collider,
   and one RAdam/Adam update on the card held against the CPU's.

6. (E) Data parallel: grid_raw_tpu over two processes on the card
   (run_data_parallel). (F) The entry scripts: scripts/profile_step.py in
   its default environment (mlp_raw_tpu, 2048 rays, 1024-ray microbatches)
   and with BENCH_GRID_* giving grid_raw_tpu capacity_base6's f32 table
   (512-ray microbatches), each op_stats.json read back, its profiled
   kernels and every wrapper's launches at PER_MICROBATCH's counts (K2f and
   K3f, never the bf16 slot kernels, under the override); then
   scripts/quality_check.py on grid_raw_tpu, rgb and mono, untrained (--steps
   0) and after QUALITY_STEPS steps: finite metrics, K1-K3 launched, and
   each modality's PSNR QUALITY_GAIN_DB over its untrained figure. The
   capture preprocessing scripts need COLMAP and OpenCV, which the card's
   machine lacks: they do not run here.

Prints each phase's seconds and the whole run's, one {"kernels": [...]}
line (launches summed over the training runs and phases A-F, each counted
from 0), each
path's rays/s, step time and busy share, and last the {"ok": true,
"device": ...} line. Exits
non-zero, printing no result, when a phase fails or no card is present.
"""

import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
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


def bound(flops: float, n_bytes: float, peak: float = H100_BF16_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, n_bytes / H100_BYTES * 1e3
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


def device_ops(fn) -> int:
    """Device operations (kernels, fills, copies) that one call of fn issues:
    the nodes of a CUDA graph that captures the call (fn must not
    synchronise). torch.profiler's per-call counts dropped events late in a
    long run."""
    import ctypes

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    runtime = ctypes.CDLL("libcudart.so.12")
    count = ctypes.c_size_t(0)
    status = runtime.cudaGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                                       ctypes.byref(count))
    if status:
        fail(f"cudaGraphGetNodes failed with status {status}")
    graph.reset()
    return count.value


def kernel_alone_ms(fn, names, reps=10) -> float:
    """Device milliseconds per call of fn spent in the kernels whose names
    contain one of `names` (torch.profiler over reps calls after warm-up):
    a wrapper's kernel alone, whatever the wrapper launches around it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # the profiler has been seen to drop every event of a window of short kernels: a window
    # that shows none of them is taken again, twice at most
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and any(s in e.key for s in names))
        if us > 0:
            return us / reps / 1e3
        print(f"  the profiler saw no device time of {names}: profiling again")
    fail(f"the profiler saw no device time of {names}")


# the K2/K2f forward's kernel, by its name in a profile: the wgmma design's,
# or the first design's slot_sdf_kernel, which a parent checkout launches
SLOT_VALUE_KERNELS = ("slot_value_kernel", "slot_sdf_kernel")


def slot_value_parts(what, fn):
    """K2's (K2f's) forward kernel alone (ms per call, profiler) and the
    device ops of one wrapper call fn; printed beside each other."""
    kernel_ms = kernel_alone_ms(fn, SLOT_VALUE_KERNELS)
    ops = device_ops(fn)
    print(f"  {what}: kernel alone {kernel_ms:.3f} ms, {ops} device ops per call")
    return kernel_ms, ops


# the adjoint and tangent forwards' kernels by their names in a profile: the passes on
# K1's blocks, or the first designs', which a parent checkout launches
ADJ_FWD_KERNELS = ("adj_fwd_kernel", "adj_chain_fwd_kernel", "slot_sdf_kernel")
TAN_FWD_KERNELS = ("tan_fwd_kernel", "chain_tangent_fwd_kernel")


def fwd_parts(what, fn, names):
    """A forward wrapper's kernel alone (ms per call, profiler) and the device
    ops of one call of fn without grad; printed beside each other."""
    with torch.no_grad():
        kernel_ms = kernel_alone_ms(fn, names)
        ops = device_ops(fn)
    print(f"  {what}: kernel alone {kernel_ms:.3f} ms, {ops} device ops per call")
    return kernel_ms, ops


def k1_forward_parts(what, x, ws, bs, kw):
    """K1's forward chain kernel alone on pre-packed images (ms) and the
    device ops of one wrapper call without grad; printed beside each other."""
    from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import bare_forward, fused_chain

    kernel_ms = time_ms(bare_forward(x, ws, bs, kw.get("skip", ()), kw["activation"],
                                     kw.get("beta", 100.0)))
    with torch.no_grad():
        ops = device_ops(lambda: fused_chain(x, ws, bs, **kw))
    print(f"  {what}: kernel alone {kernel_ms:.3f} ms, {ops} device ops per call")
    return kernel_ms, ops


K1_PARTS = ("fused_chain_pack", "chain_wgrad")


def k1_bwd_bytes(x, gy, ws, bs, out) -> int:
    """Bytes K1's backward must move: x, gy and the parameters read once, gW
    and gb written once and gx at the reference's bf16 width."""
    return nbytes(x, gy, ws, bs, out[1], out[2]) + 2 * out[0].numel()


def k1_backward_ms(x, gy, ws, bs, skip, act, beta=100.0):
    """K1's backward wrapper as the main path calls it (the autograd
    backward, which reuses the images its forward's pack wrote), and the
    wrapper alone, packing its own images: (ms, standalone ms)."""
    from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import _launch_bwd, _launch_fwd

    packed = _launch_fwd(x, ws, bs, tuple(skip), act, beta, backward_images=True)[1]
    return (time_ms(lambda: _launch_bwd(x, gy, ws, bs, tuple(skip), act, beta, packed)),
            time_ms(lambda: _launch_bwd(x, gy, ws, bs, tuple(skip), act, beta)))


def k1_backward_parts(what, x, gy, ws, bs, kw, tot):
    """K1's backward in its parts on one chain: the pack against its plain
    version (bitwise), the per-tile pass against its plain version (gx, gb,
    the hin and gz stacks; rel-L2 1e-2 as the backward checks) and
    chain_wgrad against the plain product of the pass's own stacks (rel-L2
    1e-4: the same bf16 products, summed in f32 in another order). Adds the
    pack's and chain_wgrad's times to tot["parts"] and the kernel-only time
    of the backward (pass and chain_wgrad) and the device ops of one backward
    call (the forward's images reused, as in training) to tot."""
    from multimodalstudio_tpu_torch.ops.kernels import fused_mlp as fm

    skip, act, beta = tuple(kw.get("skip", ())), kw["activation"], kw.get("beta", 100.0)
    n = x.shape[0]
    layout, packed, gx, gw, gb, scratch, tile, wgrad = fm.bare_backward(x, gy, ws, bs, skip, act,
                                                                        beta)
    want = fm.pack_plain(layout, ws, bs)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((packed.wfw, packed.wbw, packed.bpk), want)):
        fail(f"the K1 pack disagrees with its plain version at {what}")
    print(f"  K1 pack {what}: equal to its plain version, bit for bit")
    tile()
    torch.cuda.synchronize()
    p_gx, p_hin, p_gz, p_gb = fm.chain_bwd_tile_plain(x, gy, ws, bs, skip=skip, activation=act,
                                                      beta=beta)
    hins, gzs = fm.stacks_of(layout, scratch, n)
    gbs = [gb[layout.gb_off[l]:layout.gb_off[l + 1]] for l in range(layout.n_layers)]
    err = _compare_grads(f"K1 per-tile pass {what}", ("gx", "gb", "hin", "gz"),
                         (gx, gbs, hins, gzs), (p_gx, p_gb, p_hin, p_gz))
    wgrad()
    torch.cuda.synchronize()
    gws = [gw[layout.gw_off[l]:layout.gw_off[l + 1]].view(layout.din_true[l], layout.dout_true[l])
           for l in range(layout.n_layers)]
    plain_w = fm.chain_wgrad_plain(hins, gzs)
    werr = _compare_grads(f"chain_wgrad {what}", ("gW",), (gws,), (plain_w,), tol=1e-4)
    hb, gb16 = [h.contiguous() for h in hins], [g.contiguous() for g in gzs]
    parts = tot.setdefault("parts", {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0,
                                             bytes=0.0, err=0.0) for k in K1_PARTS})
    pk = parts["fused_chain_pack"]
    lg = fm.chain_of(x.shape[1], ws, skip, act, beta)[1]
    pk["ms"] += time_ms(lambda: fm._launch_pack(layout, lg, ws, bs, True))
    pk["plain_ms"] += time_ms(lambda: fm.pack_plain(layout, ws, bs))
    pk["library_ms"] = None  # no PyTorch call writes the swizzled images
    pk["bytes"] += nbytes(ws, bs, packed.wfw, packed.wbw, packed.bpk)
    wg = parts["chain_wgrad"]
    wg["ms"] += time_ms(wgrad)
    wg["plain_ms"] += time_ms(lambda: fm.chain_wgrad_plain(hins, gzs))
    wg["library_ms"] += time_ms(lambda: [torch.matmul(h.T, g) for h, g in zip(hb, gb16)])
    wg["flops"] += chain_flops(n, [tuple(w.shape) for w in ws])
    # the stacks' true columns read once (bf16), gW written once
    wg["bytes"] += 2.0 * n * sum(layout.din_true + layout.dout_true) + nbytes(gws)
    wg["err"] = max(wg["err"], werr)
    kernel_ms = time_ms(lambda: (tile(), wgrad()))
    ops = device_ops(lambda: fm._launch_bwd(x, gy, ws, bs, skip, act, beta, packed))
    tot["kernel_ms"] = tot.get("kernel_ms", 0.0) + kernel_ms
    tot["ops"] = max(tot.get("ops", 0), ops)
    print(f"  K1 bwd {what}: kernel alone (pass and chain_wgrad) {kernel_ms:.3f} ms, {ops} device "
          "ops per call with the forward's images")
    return max(err, werr)


def old_atomics(n, dims, skip, k=0):
    """gW atomics per call of the replaced per-tile designs (one per element
    of every tile's gW product, widths padded to 16): the adjoint backward's
    hin^T gz of every layer, qin^T v of the hidden layers and the last
    layer's column sums, per 64-row tile; the tangent backward's Hin^T G of
    every layer per tile of 16 (K = 2, 3) or 32 (K = 1) samples."""
    from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import rup16

    p0, hidden = rup16(dims[0][0]), dims[0][1]
    ins = [p0 if l == 0 else hidden + (p0 if l in skip else 0) for l in range(len(dims))]
    per_tile = sum(a * rup16(o) for a, (_, o) in zip(ins, dims))
    if k:
        return -(-n // (32 if k == 1 else 16)) * per_tile
    return -(-n // 64) * (per_tile + hidden * sum(ins[:-1]) + ins[-1])


def stacked_backward_parts(what, prepare, launch, rows, old, tot, gate=True):
    """A redesigned backward (K4's, K5's, K1t's, K4j's) in its parts on one
    call: `prepare(count)` gives (fused_mlp.Backward, outputs) with the gW
    atomics counted into `count`, `launch()` the wrapper call. Runs the
    per-tile pass and chain_wgrad once and holds chain_wgrad's gW (the
    pass's own column term taken off) against the plain product of the
    pass's own stacks (rel-L2 1e-4: the same bf16 products, summed in f32 in
    another order); prints the kernels' time alone (pass and chain_wgrad),
    the device ops of one wrapper call, the scratch bytes and the gW atomics
    (counted, beside the replaced design's `old`), and with `gate` fails if
    they are 1 % of the old or more (K4, K1t, K4j; K5's small chain prints
    its share). `rows` [per layer]: the stacked rows the data holds.
    Adds kernel_ms and ops to tot; returns the stacked gW's timings."""
    from multimodalstudio_tpu_torch.ops.kernels import fused_mlp as fm

    count = torch.zeros(1, dtype=torch.int64, device="cuda")
    bw = prepare(count)[0]
    bw.tile()
    torch.cuda.synchronize()
    after_pass = bw.gw.clone()
    bw.wgrad()
    torch.cuda.synchronize()
    atomics = int(count.item())
    lay = bw.layout
    hins, gzs = fm.stacks_of(lay, bw.scratch, bw.tiles * 64, tiles=bw.tiles)
    stacked = [(bw.gw - after_pass)[lay.gw_off[l]:lay.gw_off[l + 1]].view(lay.din_true[l],
                                                                            lay.dout_true[l])
               for l in range(lay.n_layers)]
    plain_w = fm.chain_wgrad_plain(hins, gzs)
    err = _compare_grads(f"{what} stacked gW (chain_wgrad) vs its own stacks", ("gW",), (stacked,),
                         (plain_w,), tol=1e-4)
    hb, gb16 = [h.contiguous() for h in hins], [g.contiguous() for g in gzs]
    wgrad = dict(ms=time_ms(bw.wgrad), plain_ms=time_ms(lambda: fm.chain_wgrad_plain(hins, gzs)),
                 library_ms=time_ms(lambda: [torch.matmul(h.T, g) for h, g in zip(hb, gb16)]),
                 flops=sum(2.0 * r * a * b for r, a, b in zip(rows, lay.din_true, lay.dout_true)),
                 bytes=sum(2.0 * r * (a + b) for r, a, b in zip(rows, lay.din_true, lay.dout_true))
                 + 4.0 * lay.gw_off[-1], err=err)
    kernel_ms = time_ms(lambda: (bw.tile(), bw.wgrad()))
    ops = device_ops(launch)
    tot["kernel_ms"], tot["ops"] = kernel_ms, ops
    share = atomics / old
    print(f"  {what}: kernel alone (pass and chain_wgrad) {kernel_ms:.3f} ms, {ops} device ops per "
          f"call, scratch {bw.scratch.numel()} bytes, gW atomics per call {atomics} (the replaced "
          f"design's {old}: {100 * share:.3f}%), chain_wgrad {wgrad['ms']:.3f} ms")
    if gate and not share < 1e-2:
        fail(f"{what}: the gW atomics are not under 1% of the replaced design's")
    return wgrad


def check_fused_chain(gen, dev):
    """K1 at the five chain shapes of one 1024-ray chunk."""
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
        kernel_ms, ops = k1_forward_parts(f"K1 {name}", x, ws, bs, dict(activation=act))
        tot["kernel_ms"] = tot.get("kernel_ms", 0.0) + kernel_ms
        tot["ops"] = max(tot.get("ops", 0), ops)
    print(f"  K1 forward, the five chains: wrapper {tot['ms']:.3f} ms, kernel alone "
          f"{tot['kernel_ms']:.3f} ms, at most {tot['ops']} device ops per call, library "
          f"{tot['library_ms']:.3f} ms")
    return tot


def slot_inputs(gen, dev, gspec):
    """A table and the grid_raw_tpu SDF chain (3 + 36 PE columns and the
    grid's -> 128 -> 128 -> 257) for gspec."""
    from multimodalstudio_tpu_torch.ops.kernels.slot_grid import make_table_init

    # the table init is uniform +-1e-4, which would hide gather faults: scale it up
    table = make_table_init(gspec)(gen) * 1e4
    ws, bs = random_chain(gen, [(slot_d_in(gspec), 128), (128, 128), (128, 257)], dev)
    return table, ws, bs


def f32_spec():
    """The slot grid of grid_raw_tpu with an f32 table: 6 levels of 512
    entries, F = 16 (K2f, K3f)."""
    from multimodalstudio_tpu_torch.ops.kernels.slot_grid import SlotGridSpec

    return SlotGridSpec(num_levels=6, min_res=16, max_res=512, rows_per_level=512, layout="cell",
                        feats=16, table_dtype="f32")


def vertex_spec():
    """The slot grid of grid_raw_tpu without PE on the vertex layout's table:
    6 levels of 2048 rows, F = 16, f32 (K6v)."""
    from multimodalstudio_tpu_torch.ops.kernels.slot_grid import SlotGridSpec

    return SlotGridSpec(num_levels=6, min_res=16, max_res=512, rows_per_level=2048,
                        layout="vertex", feats=16, table_dtype="f32")


def slot_d_in(gspec):
    """The slot chain's input width: 3 + 36 PE columns and the grid's."""
    return 39 + gspec.out_dim


def slot_tag(name, gspec):
    """A slot kernel's label, "K2" or "K2f" (f32 table)."""
    return name + ("f" if gspec.table_dtype == "f32" else "")


SLOT_KW = dict(radius=1.0, num_frequencies=6, min_freq_exp=0.0, max_freq_exp=5.0,
               activation="SoftplusQuad", beta=100.0)


def check_slot_value(gen, dev, gspec):
    """K2 (K2f for an f32 table) at one chunk's sampler queries: N=32768
    then 3 x 8192, 4 levels."""
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
        print(f"  {slot_tag('K2', gspec)} N={n}: rel_l2={rel:.3e} max_abs={err:.3e} "
              "(tolerance rel_l2 <= 1e-2)")
        if not (rel <= 1e-2 and torch.isfinite(sdf).all()):
            fail("fused_slot_sdf_value disagrees with its plain version")
        tot["ms"] += count * time_ms(lambda: fused_slot_sdf_value(*args, **kw))
        tot["plain_ms"] += count * time_ms(lambda: slot_sdf_value_plain(*args, **kw))
        kernel_ms, ops = slot_value_parts(f"{slot_tag('K2', gspec)} N={n}",
                                          lambda: fused_slot_sdf_value(*args, **kw))
        tot["kernel_ms"] = tot.get("kernel_ms", 0.0) + count * kernel_ms
        tot["ops"] = max(tot.get("ops", 0), ops)
        # sdf needs column 0 of the last layer only
        tot["flops"] += count * 2.0 * n * (slot_d_in(gspec) * 128 + 128 * 128 + 128 * 1)
        tot["bytes"] += count * nbytes(pos, table, mask, ws, bs, sdf)
        tot["err"] = max(tot["err"], err)
    print(f"  {slot_tag('K2', gspec)} per chunk: wrapper {tot['ms']:.3f} ms, kernel alone "
          f"{tot['kernel_ms']:.3f} ms, at most {tot['ops']} device ops per call")
    return tot


def check_slot_chain(gen, dev, gspec):
    """K3 (K3f for an f32 table) at one chunk's render samples: N=65536, all
    6 levels."""
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
        print(f"  {slot_tag('K3', gspec)} {name}: rel_l2={rel:.3e} max_abs={e:.3e} "
              "(tolerance rel_l2 <= 1e-2)")
        if not (rel <= 1e-2 and torch.isfinite(a.float()).all()):
            fail(f"fused_slot_sdf_chain disagrees with its plain version on {name}")
    d_in = slot_d_in(gspec)
    flops = 2.0 * n * (d_in * 128 + 128 * 128 + 128 * 257) + 2.0 * n * (128 * 128 + 128 * d_in)
    ms = time_ms(lambda: fused_slot_sdf_chain(*args, **kw))
    kernel_ms, ops = fwd_parts(f"{slot_tag('K3', gspec)} fwd N={n} (wrapper {ms:.3f} ms)",
                               lambda: fused_slot_sdf_chain(*args, **kw), ADJ_FWD_KERNELS)
    return dict(ms=ms, plain_ms=time_ms(lambda: slot_sdf_chain_plain(*args, **kw)),
                flops=flops, bytes=nbytes(pos, table, mask, ws, bs, out), err=err,
                kernel_ms=kernel_ms, ops=ops)


def chain_flops(n, dims):
    return 2.0 * n * sum(a * b for a, b in dims)


def check_fused_chain_bwd(gen, dev):
    """K1's backward at the five chain shapes of one training microbatch
    (512 rays per modality: 2560 rays x 64 samples, 16 background samples,
    one modality's rays through each polarization head)."""
    from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import _launch_bwd, fused_chain_bwd_plain

    shapes = [  # (name, N, dims)
        ("radiance trunk", 163840, [(285, 256), (256, 256), (256, 256)]),
        ("polarization head", 32768, [(256, 256), (256, 256), (256, 3)]),
        ("background base", 40960, [(39, 256), (256, 256), (256, 256), (256, 256)]),
        ("background head", 40960, [(283, 128), (128, 128), (128, 128), (128, 128)]),
        ("background polarization head", 8192, [(128, 256), (256, 256), (256, 3)]),
    ]
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0, err=0.0)
    for name, n, dims in shapes:
        ws, bs = random_chain(gen, dims, dev)
        x = (torch.rand(n, dims[0][0], generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
        gy = torch.randn(n, dims[-1][1], generator=gen, device=dev).to(torch.bfloat16)
        out = _launch_bwd(x, gy, ws, bs, (), "ReLU", 100.0)
        ref = fused_chain_bwd_plain(x, gy, ws, bs, activation="ReLU")
        torch.cuda.synchronize()
        err = _compare_grads(f"K1 bwd {name} N={n}", CHAIN_GRADS, out, ref)
        wb = [w.t().contiguous().to(torch.bfloat16).requires_grad_(True) for w in ws]
        bb = [b.to(torch.bfloat16).requires_grad_(True) for b in bs]
        xl = x.clone().requires_grad_(True)
        h = xl
        for l, (w, b) in enumerate(zip(wb, bb)):
            h = F.linear(h, w, b)
            if l < len(wb) - 1:
                h = torch.relu(h)

        def library():
            return torch.autograd.grad(h, [xl, *wb, *bb], gy, retain_graph=True)

        ms, alone_ms = k1_backward_ms(x, gy, ws, bs, (), "ReLU")
        tot["ms"] += ms
        tot["standalone_ms"] = tot.get("standalone_ms", 0.0) + alone_ms
        tot["plain_ms"] += time_ms(lambda: fused_chain_bwd_plain(x, gy, ws, bs, activation="ReLU"))
        tot["library_ms"] += time_ms(library)
        # forward recompute of the hidden layers, then gW and gh of every layer
        tot["flops"] += chain_flops(n, dims[:-1]) + 2 * chain_flops(n, dims)
        tot["bytes"] += k1_bwd_bytes(x, gy, ws, bs, out)
        tot["err"] = max(tot["err"], err, k1_backward_parts(name, x, gy, ws, bs,
                                                            dict(activation="ReLU"), tot))
    print(f"  K1 backward, the five chains: wrapper {tot['ms']:.3f} ms with the forward's images "
          f"({tot['standalone_ms']:.3f} ms packing its own), kernel alone {tot['kernel_ms']:.3f} ms, "
          f"at most {tot['ops']} device ops per call, library {tot['library_ms']:.3f} ms")
    return tot


CHAIN_GRADS = ("d_in", "gW", "gb")  # what K1's and K4's backwards return
SLOT_GRADS = ("d_pos", "d_table", "gW", "gb")  # K2's and K3's


def _flat(a) -> torch.Tensor:
    """A gradient (a tensor, or a list of per-layer tensors) as one f32 vector."""
    return torch.cat([t.float().reshape(-1) for t in (a if isinstance(a, list) else [a])])


def _compare_grads(what, names, out, ref, tol=1e-2):
    """rel-L2 of each named gradient (a tensor, or a list of per-layer
    tensors taken together) within tol (one limit, or one per name);
    returns the largest abs error."""
    err = 0.0
    tols = tol if isinstance(tol, (list, tuple)) else [tol] * len(names)
    for part, a, b, tol in zip(names, out, ref, tols):
        a, b = _flat(a), _flat(b)
        rel = rel_l2(a, b)
        err = max(err, float((a - b).abs().max()))
        print(f"  {what} {part}: rel_l2={rel:.3e} (tolerance rel_l2 <= {tol:g})")
        if not (rel <= tol and torch.isfinite(a).all()):
            fail(f"{what} disagrees with its plain version on {part}")
    return err


def _report_grads(what, names, out, ref, tol):
    """rel-L2 of each named gradient beside the limit a held check would
    take, printed only (check_wide_hidden past 512)."""
    tols = tol if isinstance(tol, (list, tuple)) else [tol] * len(names)
    for part, a, b, t in zip(names, out, ref, tols):
        a, b = _flat(a), _flat(b)
        if not torch.isfinite(a).all():
            fail(f"{what}: {part} is not finite")
        print(f"  {what} {part}: rel_l2={rel_l2(a, b):.3e} (the plain spread's limit {t:g}; "
              "printed, held by check_padded_widths)")


def _compare_outputs(what, names, out, ref, tol=1e-2):
    """rel-L2 of each named forward output or residual; returns the largest
    abs error."""
    err = 0.0
    for name, a, b in zip(names, out, ref):
        a, b = a.float(), b.float()
        rel = rel_l2(a, b)
        err = max(err, float((a - b).abs().max()))
        print(f"  {what} {name}: rel_l2={rel:.3e} (tolerance rel_l2 <= {tol:g})")
        if not (rel <= tol and torch.isfinite(a).all()):
            fail(f"{what} disagrees with its plain version on {name}")
    return err


def check_slot_value_bwd(gen, dev, gspec):
    """K2's (K2f's) training forward and its backward at one training
    microbatch's curvature taps: N=81920 (16 strided samples x 2 taps x
    2560 rays), all 6 levels, 3 active. The forward's sdf and residual zs are
    held against the plain forward's; each backward reads its own forward's
    residuals. The backward's limits follow the plain version's spread
    (_plain_conditioning), whose own generator leaves `gen`'s draws as they
    were: the f32 table's grid columns (F = 16) reach x0 through many bf16
    roundings, and a fixed 1e-2 sat inside the bf16 table's spread on
    another draw."""
    from multimodalstudio_tpu_torch.ops.kernels.slot_fused import (
        _launch,
        _launch_value,
        _launch_value_bwd,
        _value_fwd_plain,
        pe_scales,
        slot_sdf_value_bwd_plain,
    )

    what = slot_tag("K2", gspec)
    table, ws, bs = slot_inputs(gen, dev, gspec)
    n = 81920
    pos = torch.rand(n, 3, generator=gen, device=dev) * 2.2 - 1.1
    mask = (torch.arange(gspec.out_dim, device=dev) < 3 * gspec.feats).float()
    pe = pe_scales(6, 0.0, 5.0)
    fwd = (pos, table, ws, bs, gspec, gspec.num_levels, 1.0, pe, "SoftplusQuad", 100.0, mask)
    # the training forward, its pack writing the backward images the backward reuses
    (sdf, zs, _), packed = _launch_value(*fwd, resid=True, backward_images=True)
    sdf_p, zs_p, _ = _value_fwd_plain(*fwd)
    fwd_err = _compare_outputs(f"{what} training fwd N={n}", ("sdf", "zs"), (sdf, zs),
                               (sdf_p, zs_p))
    fwd_ms = time_ms(lambda: _launch(*fwd, False, resid=True))
    slot_value_parts(f"{what} training fwd N={n} (wrapper {fwd_ms:.3f} ms)",
                     lambda: _launch(*fwd, False, resid=True))
    gsdf = torch.randn(n, generator=gen, device=dev)
    args = (*fwd, zs, gsdf)
    plain_kw = dict(SLOT_KW, level_mask=mask)

    def plain(b):
        """The plain forward with biases b, then the plain backward."""
        zs_b = _value_fwd_plain(pos, table, ws, b, *fwd[4:])[1]
        return slot_sdf_value_bwd_plain(pos, table, ws, b, gspec, zs_b, gsdf, **plain_kw)

    out = _launch_value_bwd(*args, packed=packed)
    ref = slot_sdf_value_bwd_plain(pos, table, ws, bs, gspec, zs_p, gsdf, **plain_kw)
    torch.cuda.synchronize()
    limits = _plain_conditioning(f"{what} bwd N={n}", SLOT_GRADS, plain, lambda b: (b,), bs, {},
                                 torch.Generator(device=dev).manual_seed(SEED), dev, ref)
    err = _compare_grads(f"{what} bwd N={n}", SLOT_GRADS, out, ref, tol=limits)
    ms = time_ms(lambda: _launch_value_bwd(*args, packed=packed))
    parts = k2_parts(f"{what} bwd N={n} (wrapper {ms:.3f} ms with the forward's images, "
                     f"{time_ms(lambda: _launch_value_bwd(*args)):.3f} ms packing its own)",
                     fwd, zs, gsdf, packed)
    # the last layer's cotangent is sdf's column only
    dims = [(slot_d_in(gspec), 128), (128, 128), (128, 1)]
    return dict(ms=ms,
                plain_ms=time_ms(lambda: slot_sdf_value_bwd_plain(
                    pos, table, ws, bs, gspec, zs_p, gsdf, **plain_kw)),
                flops=2 * chain_flops(n, dims),
                bytes=nbytes(pos, table, mask, ws, bs, zs, gsdf, out[0], out[1], out[2], out[3]),
                err=err, fwd_err=fwd_err, **parts)


def k2_parts(what, fwd, zs, gsdf, packed):
    """K2's merged backward in its parts on one call, as the main path calls
    it (on its forward's images `packed`): the value mode of the pass and
    chain_wgrad alone (ms), the device ops of one wrapper call, and
    chain_wgrad against the plain product of the pass's own stacks (rel-L2
    1e-4: the same bf16 products, summed in f32 in another order); printed.
    Returns kernel_ms, ops and chain_wgrad's entry (wgrad)."""
    from multimodalstudio_tpu_torch.ops.kernels import fused_mlp as fm
    from multimodalstudio_tpu_torch.ops.kernels.slot_fused import _launch_value_bwd, value_bwd_card

    bw = value_bwd_card(*fwd, zs, gsdf, packed=packed)[0]
    kernel_ms = time_ms(lambda: (bw.tile(), bw.wgrad()))
    wgrad_ms = time_ms(bw.wgrad)
    ops = device_ops(lambda: _launch_value_bwd(*fwd, zs, gsdf, packed=packed))
    bw.gw.zero_()
    bw.wgrad()
    torch.cuda.synchronize()
    lay = bw.layout
    hins, gzs = fm.stacks_of(lay, bw.scratch, bw.tiles * 64, tiles=bw.tiles)
    stacked = [bw.gw[lay.gw_off[l]:lay.gw_off[l + 1]].view(lay.din_true[l], lay.dout_true[l])
               for l in range(lay.n_layers)]
    werr = _compare_grads(f"{what.split(' (')[0]} stacked gW (chain_wgrad) vs its own stacks",
                          ("gW",), (stacked,), (fm.chain_wgrad_plain(hins, gzs),), tol=1e-4)
    n = zs.shape[1]
    hb, gb16 = [h.contiguous() for h in hins], [g.contiguous() for g in gzs]
    wgrad = dict(ms=wgrad_ms, plain_ms=time_ms(lambda: fm.chain_wgrad_plain(hins, gzs)),
                 library_ms=time_ms(lambda: [torch.matmul(h.T, g) for h, g in zip(hb, gb16)]),
                 flops=sum(2.0 * n * a * b for a, b in zip(lay.din_true, lay.dout_true)),
                 bytes=sum(2.0 * n * (a + b) for a, b in zip(lay.din_true, lay.dout_true))
                 + 4.0 * lay.gw_off[-1], err=werr)
    print(f"  {what}: kernel alone (pass and chain_wgrad) {kernel_ms:.3f} ms, chain_wgrad "
          f"{wgrad_ms:.3f} ms, {ops} device ops per call, scratch {bw.scratch.numel()} bytes")
    return dict(kernel_ms=kernel_ms, ops=ops, wgrad=wgrad)


def ray_positions(n, dev, seed, per_ray=320):
    """Positions as the sampler emits them: rays of `per_ray` consecutive
    samples, each ray a segment through the scene box from a uniform origin
    in a uniform direction, its samples in order along it (N = 163840 is a
    training microbatch's 512 rays of 320 samples). Drawn from a generator
    of their own, so that no other check's inputs change."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rays = -(-n // per_ray)
    o = torch.rand(rays, 1, 3, generator=g, device=dev) * 2.2 - 1.1
    d = torch.nn.functional.normalize(torch.randn(rays, 1, 3, generator=g, device=dev), dim=-1)
    t = torch.linspace(0.0, 1.0, per_ray, device=dev)[None, :, None]
    return (o + 1.1 * t * d).reshape(-1, 3)[:n].clamp(-1.1, 1.1).contiguous()


def table_reductions(d_comp, gspec):
    """(the replaced design's table atomics: one per nonzero value, the pass's
    vector reductions: one per four adjacent corners of a feature with a
    nonzero value) of a merged K3 backward whose per-sample table cotangent
    is d_comp [N, K, F, 8] (rounded by the table's type first)."""
    from multimodalstudio_tpu_torch.ops.kernels.slot_fused import _compact

    v = _compact(d_comp, gspec).float()
    return int((v != 0).sum()), int((v.reshape(-1, 4) != 0).any(-1).sum())


def k3_parts(what, args, gspec, split, packed=None):
    """K3's backward (merged, or the split's pass) in its parts on one call:
    the pass and chain_wgrad alone (ms), chain_wgrad alone (ms), the device
    ops of one wrapper call (merged: _launch_chain_bwd; split: the whole
    split backward, the scatter included) on the forward's images `packed`
    where given; printed beside each other."""
    from multimodalstudio_tpu_torch.ops.kernels.slot_fused import (
        _chain_split_card,
        _launch_chain_bwd,
        chain_bwd_card,
    )

    bw = chain_bwd_card(*args, split=split, packed=packed)[0]
    kernel_ms = time_ms(lambda: (bw.tile(), bw.wgrad()))
    wgrad_ms = time_ms(bw.wgrad)
    if split:
        ops = device_ops(lambda: _chain_split_card(*args, packed=packed))
    else:
        ops = device_ops(lambda: _launch_chain_bwd(*args, packed=packed))
    print(f"  {what}: kernel alone (pass and chain_wgrad) {kernel_ms:.3f} ms, chain_wgrad "
          f"{wgrad_ms:.3f} ms, {ops} device ops per call, scratch {bw.scratch.numel()} bytes")
    return dict(kernel_ms=kernel_ms, wgrad_ms=wgrad_ms, ops=ops, bw=bw)


def check_slot_chain_bwd(gen, dev, gspec):
    """K3's (K3f's) training forward and its backward at one training
    microbatch's render samples: N=163840, all 6 levels, 3 active,
    cotangents on sdf, geo and grad. The forward's sdf, geo, grad and
    residuals zs, ss and adj are held against the plain forward's; each
    backward reads its own forward's residuals. The backward's limits follow
    the plain version's spread, as for K2. Then the backward in its parts
    (the pass and chain_wgrad alone, chain_wgrad against the plain product of
    the pass's own stacks at 1e-4, the device ops, the table reductions
    beside the replaced design's atomics), and again at positions ordered as
    the sampler emits them (ray_positions), where neighbouring samples share
    cells: against the plain backward at the same limits. Returns the
    merged backward's timings and chain_wgrad's entry."""
    from multimodalstudio_tpu_torch.ops.kernels import fused_mlp as fm
    from multimodalstudio_tpu_torch.ops.kernels.slot_fused import (
        _chain_bwd_parts,
        _chain_fwd_plain,
        _launch,
        _launch_chain,
        _launch_chain_bwd,
        pe_scales,
        slot_sdf_chain_bwd_plain,
    )

    what = slot_tag("K3", gspec)
    table, ws, bs = slot_inputs(gen, dev, gspec)
    n = 163840
    pos = torch.rand(n, 3, generator=gen, device=dev) * 2.2 - 1.1
    mask = (torch.arange(gspec.out_dim, device=dev) < 3 * gspec.feats).float()
    pe = pe_scales(6, 0.0, 5.0)
    fwd = (pos, table, ws, bs, gspec, 1.0, pe, "SoftplusQuad", 100.0, mask)
    # the training forward, its pack writing the images the backward reuses
    out_k, packed = _launch_chain(*fwd, resid=True)
    outs_p, (zs_p, ss_p, adj_p, _) = _chain_fwd_plain(*fwd)
    fwd_err = _compare_outputs(f"{what} training fwd N={n}",
                               ("sdf", "geo", "grad", "zs", "ss", "adj"), out_k,
                               (*outs_p, zs_p, ss_p, adj_p))
    zs, ss, adj = out_k[3:6]
    gsdf = torch.randn(n, generator=gen, device=dev)
    ggeo = (0.1 * torch.randn(n, 256, generator=gen, device=dev)).to(torch.bfloat16)
    g3 = torch.randn(n, 3, generator=gen, device=dev)
    args = (*fwd, zs, ss, adj, gsdf, ggeo, g3)
    plain_kw = dict(SLOT_KW, level_mask=mask)

    def plain(b, p=pos):
        """The plain forward with biases b, then the plain backward."""
        resid = _chain_fwd_plain(p, table, ws, b, *fwd[4:])[1][:3]
        return slot_sdf_chain_bwd_plain(p, table, ws, b, gspec, *resid, gsdf, ggeo, g3,
                                        **plain_kw)

    out = _launch_chain_bwd(*args)
    ref = slot_sdf_chain_bwd_plain(pos, table, ws, bs, gspec, zs_p, ss_p, adj_p, gsdf, ggeo, g3,
                                   **plain_kw)
    torch.cuda.synchronize()
    limits = _plain_conditioning(f"{what} bwd N={n}", SLOT_GRADS, plain, lambda b: (b,), bs, {},
                                 torch.Generator(device=dev).manual_seed(SEED), dev, ref)
    err = _compare_grads(f"{what} bwd N={n}", SLOT_GRADS, out, ref, tol=limits)
    parts = k3_parts(f"{what} bwd N={n}", args, gspec, False, packed)
    # chain_wgrad against the plain product of the pass's own stacks
    bw = parts.pop("bw")
    bw.gw.zero_()
    bw.wgrad()
    torch.cuda.synchronize()
    lay = bw.layout
    hins, gzs = fm.stacks_of(lay, bw.scratch, bw.tiles * 64, tiles=bw.tiles)
    stacked = [bw.gw[lay.gw_off[l]:lay.gw_off[l + 1]].view(lay.din_true[l], lay.dout_true[l])
               for l in range(lay.n_layers)]
    werr = _compare_grads(f"{what} stacked gW (chain_wgrad) vs its own stacks", ("gW",),
                          (stacked,), (fm.chain_wgrad_plain(hins, gzs),), tol=1e-4)
    rows = [2 * n] * (lay.n_layers - 1) + [n]
    hb, gb16 = [h.contiguous() for h in hins], [g.contiguous() for g in gzs]
    wgrad = dict(ms=parts["wgrad_ms"], plain_ms=time_ms(lambda: fm.chain_wgrad_plain(hins, gzs)),
                 library_ms=time_ms(lambda: [torch.matmul(h.T, g) for h, g in zip(hb, gb16)]),
                 flops=sum(2.0 * r * a * b for r, a, b in zip(rows, lay.din_true, lay.dout_true)),
                 bytes=sum(2.0 * r * (a + b) for r, a, b in zip(rows, lay.din_true, lay.dout_true))
                 + 4.0 * lay.gw_off[-1], err=werr)
    del hins, gzs, hb, gb16, stacked, bw
    d_comp = _chain_bwd_parts(pos, table, ws, gspec, zs_p, ss_p, adj_p, gsdf, ggeo, g3, 1.0, pe,
                              "SoftplusQuad", 100.0, mask)[1]
    old, new = table_reductions(d_comp, gspec)
    print(f"  {what} bwd N={n}: table reductions issued {new} (float4), the replaced design's "
          f"f32 atomics {old}")
    # the ray-ordered draw
    rpos = ray_positions(n, dev, SEED + 1)
    rfwd = (rpos, *fwd[1:])
    r_out = _launch(*rfwd[:5], gspec.num_levels, *rfwd[5:], True, resid=True)
    rargs = (*rfwd, *r_out[3:6], gsdf, ggeo, g3)
    rref = plain(bs, rpos)
    torch.cuda.synchronize()
    _compare_grads(f"{what} bwd N={n}, ray-ordered", SLOT_GRADS, _launch_chain_bwd(*rargs), rref,
                   tol=limits)
    r_parts = k3_parts(f"{what} bwd N={n}, ray-ordered", rargs, gspec, False)
    r_parts.pop("bw")
    rzs, rss, radj = _chain_fwd_plain(*rfwd)[1][:3]
    r_old, r_new = table_reductions(_chain_bwd_parts(rpos, table, ws, gspec, rzs, rss, radj, gsdf,
                                                     ggeo, g3, 1.0, pe, "SoftplusQuad", 100.0,
                                                     mask)[1], gspec)
    print(f"  {what} bwd N={n}, ray-ordered: table reductions issued {r_new} (float4), the "
          f"replaced design's f32 atomics {r_old}; wrapper "
          f"{time_ms(lambda: _launch_chain_bwd(*rargs)):.3f} ms")
    hidden = [(slot_d_in(gspec), 128), (128, 128)]
    dims = hidden + [(128, 257)]
    # ga-forward (gW and mq of the hidden layers, the last layer's column
    # sums), then gW and gh of every layer
    flops = 2 * chain_flops(n, hidden) + 2.0 * n * 128 + 2 * chain_flops(n, dims)
    return dict(ms=time_ms(lambda: _launch_chain_bwd(*args, packed=packed)),
                standalone_ms=time_ms(lambda: _launch_chain_bwd(*args)),
                plain_ms=time_ms(lambda: slot_sdf_chain_bwd_plain(
                    pos, table, ws, bs, gspec, zs_p, ss_p, adj_p, gsdf, ggeo, g3, **plain_kw)),
                flops=flops,
                bytes=nbytes(pos, table, mask, ws, bs, zs, ss, adj, gsdf, ggeo, g3, out[0],
                             out[1], out[2], out[3]),
                err=err, fwd_err=fwd_err, kernel_ms=parts["kernel_ms"], ops=parts["ops"],
                reductions=new, old_atomics=old, wgrad=wgrad)


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
    check_edge_cases_bwd(gen, dev, gspec, n)


def check_k1_piece_offsets(dev, n) -> None:
    """K1 with outputs of 40 and 100 columns (padded to 48 and 112): their
    last piece of 16 columns starts 32 columns into a 64-column image of gz,
    the one place where chain_wgrad's B operand starts inside a swizzle atom.
    The forward and the backward against their plain versions, the backward
    also in its parts; inputs from a generator of their own, so the phases
    after this one draw what they drew before."""
    from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import (
        _launch_bwd,
        fused_chain,
        fused_chain_bwd_plain,
        fused_chain_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED)
    for d_out in (40, 100):
        dims = [(39, 128), (128, 128), (128, d_out)]
        ws, bs = random_chain(gen, dims, dev)
        x = torch.rand(n, 39, generator=gen, device=dev) * 2 - 1
        gy = torch.randn(n, d_out, generator=gen, device=dev)
        rel = rel_l2(fused_chain(x, ws, bs, activation="ReLU").float(),
                     fused_chain_plain(x, ws, bs, activation="ReLU").float())
        print(f"  K1 {d_out} outputs N={n}: rel_l2={rel:.3e} (tolerance rel_l2 <= 1e-2)")
        if not rel <= 1e-2:
            fail(f"fused_chain disagrees with its plain version at {d_out} outputs")
        out = _launch_bwd(x, gy, ws, bs, (), "ReLU", 100.0)
        ref = fused_chain_bwd_plain(x, gy, ws, bs, activation="ReLU")
        _compare_grads(f"K1 bwd {d_out} outputs N={n}", CHAIN_GRADS, out, ref)
        k1_backward_parts(f"{d_out} outputs N={n}", x, gy, ws, bs, dict(activation="ReLU"), {})


def check_edge_cases_bwd(gen, dev, gspec, n) -> None:
    """The backwards off the training shapes: a ragged N, a skip layer and
    the None activation (K1), a truncated grid with a partial mask (K2),
    and K3 with ReLU (no act'' injections)."""
    from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import _launch_bwd, fused_chain_bwd_plain
    from multimodalstudio_tpu_torch.ops.kernels.slot_fused import (
        _chain_fwd_plain,
        _launch,
        _launch_chain_bwd,
        _launch_value_bwd,
        _value_fwd_plain,
        pe_scales,
        slot_sdf_chain_bwd_plain,
        slot_sdf_value_bwd_plain,
    )

    chains = (("SoftplusQuad", (2,), [(39, 128), (128, 128), (167, 128), (128, 17)]),
              ("None", (), [(39, 128), (128, 5)]))
    for act, skip, dims in chains:
        ws, bs = random_chain(gen, dims, dev)
        x = torch.rand(n, 39, generator=gen, device=dev) * 2 - 1
        gy = torch.randn(n, dims[-1][1], generator=gen, device=dev)
        out = _launch_bwd(x, gy, ws, bs, skip, act, 100.0)
        ref = fused_chain_bwd_plain(x, gy, ws, bs, skip=skip, activation=act)
        _compare_grads(f"K1 bwd {act} skip={skip} N={n}", CHAIN_GRADS, out, ref)
    check_k1_piece_offsets(dev, n)
    table, ws, bs = slot_inputs(gen, dev, gspec)
    pos = torch.rand(n, 3, generator=gen, device=dev) * 2.2 - 1.1
    pe = pe_scales(6, 0.0, 5.0)
    feats = gspec.feats
    mask = (torch.arange(3 * feats, device=dev) < 2 * feats).float()
    fwd = (pos, table, ws, bs, gspec, 3, 1.0, pe, "SoftplusQuad", 100.0, mask)
    sdf, _, _, zs, _, _, _ = _launch(*fwd, False, resid=True)
    sdf_p, zs_p, _ = _value_fwd_plain(*fwd)
    _compare_outputs(f"K2 training fwd 3 levels, 2 active, N={n}", ("sdf", "zs"), (sdf, zs),
                     (sdf_p, zs_p))
    gsdf = torch.randn(n, generator=gen, device=dev)
    out = _launch_value_bwd(*fwd, zs, gsdf)
    ref = slot_sdf_value_bwd_plain(pos, table, ws, bs, gspec, zs_p, gsdf, **SLOT_KW,
                                   level_mask=mask, num_levels=3)
    _compare_grads(f"K2 bwd 3 levels, 2 active, N={n}", SLOT_GRADS, out, ref)
    rows = int(gspec.level_offsets[2])
    if float(out[1][rows:].abs().max()) != 0.0:
        fail("K2 backward wrote table gradient into inactive levels")
    mask = torch.ones(gspec.out_dim, device=dev)
    kw = dict(SLOT_KW, activation="ReLU")
    fwd = (pos, table, ws, bs, gspec, 1.0, pe, "ReLU", 100.0, mask)
    out_k = _launch(*fwd[:5], gspec.num_levels, *fwd[5:], True, resid=True)
    outs_p, (zs_p, ss_p, adj_p, _) = _chain_fwd_plain(*fwd)
    _compare_outputs(f"K3 training fwd ReLU N={n}", ("sdf", "geo", "grad", "zs", "ss", "adj"),
                     out_k, (*outs_p, zs_p, ss_p, adj_p))
    ggeo = torch.randn(n, 256, generator=gen, device=dev).to(torch.bfloat16)
    g3 = torch.randn(n, 3, generator=gen, device=dev)
    out = _launch_chain_bwd(*fwd, *out_k[3:6], gsdf, ggeo, g3)
    ref = slot_sdf_chain_bwd_plain(pos, table, ws, bs, gspec, zs_p, ss_p, adj_p, gsdf, ggeo, g3,
                                   **kw, level_mask=mask)
    _compare_grads(f"K3 bwd ReLU N={n}", SLOT_GRADS, out, ref)


# the mlp_raw_tpu SDF chain: NeRF encoding (6 frequencies, 39 columns), 8 x 256
# SoftplusQuad with a skip at layer 4, sdf + 256 geometric features
SDF_DIMS = [(39, 256), (256, 256), (256, 256), (256, 256), (295, 256), (256, 256), (256, 256),
            (256, 257)]
SDF_KW = dict(num_frequencies=6, min_freq_exp=0.0, max_freq_exp=5.0, skip=(4,),
              activation="SoftplusQuad", beta=100.0)
# the mlp_raw_tpu radiance trunk: 285 inputs, 8 x 256 ReLU with a skip at layer 4
TRUNK_DIMS = [(285, 256), (256, 256), (256, 256), (256, 256), (541, 256), (256, 256), (256, 256),
              (256, 256)]


def sdf_flops(n, dims, backward=False):
    """Tensor-core flops of K4 and K5: forward = primal chain + adjoint
    sweep through the hidden layers and layer 0 (the last layer's adjoint
    product is a column of W, v being one-hot: no products); backward =
    primal and adjoint recompute (hidden layers), the ga-forward chain (gW
    and m of the hidden layers, the last layer's column sums), gW and gh of
    every layer."""
    hidden = dims[:-1]
    if not backward:
        return chain_flops(n, dims) + chain_flops(n, hidden)
    return (2 * chain_flops(n, hidden) + 2 * chain_flops(n, hidden)
            + 2.0 * n * dims[-1][0] + 2 * chain_flops(n, dims))


def linear_chain(x0, wb, bb, skip=(), activation="SoftplusQuad", beta=100.0):
    """The bf16 F.linear chain (cuBLAS) of the library compositions: wb, bb
    the transposed bf16 weights and the bf16 biases, a skip layer's input
    concat(h, x0) / sqrt(2)."""
    a = 2.0 / beta
    h = x0
    for l, (w, b) in enumerate(zip(wb, bb)):
        if l in skip:
            h = torch.cat([h, x0], dim=-1) * (2.0 ** -0.5)
        h = F.linear(h, w, b)
        if l < len(wb) - 1:
            h = (torch.relu(h) if activation == "ReLU" else
                 torch.where(h.abs() < a, (h + a) * (h + a) * (0.25 / a), torch.relu(h)))
    return h


def bf16_leaves(ws, bs, requires_grad):
    return ([w.t().contiguous().to(torch.bfloat16).requires_grad_(requires_grad) for w in ws],
            [b.to(torch.bfloat16).requires_grad_(requires_grad) for b in bs])


def adjoint_library(x, ws, bs, skip=(), beta=100.0, encode=None, create_graph=False):
    """One PyTorch composition computing the adjoint chains' function: the
    chain input (encode(x), or x), linear_chain with SoftplusQuad, and
    torch.autograd.grad for d y_0 / d x. Returns (fn, leaves): fn() -> (y
    bf16, d y_0 / d x)."""
    wb, bb = bf16_leaves(ws, bs, create_graph)
    p = x.detach().clone() if encode else x.detach().to(torch.bfloat16)
    p.requires_grad_(True)

    def fn():
        h = linear_chain((encode(p) if encode else p).to(torch.bfloat16), wb, bb, skip, beta=beta)
        return h, torch.autograd.grad(h[:, 0].float().sum(), p, create_graph=create_graph)[0]

    return fn, [p, *wb, *bb]


def sdf_library(pos, ws, bs, kw, create_graph=False):
    """K4's function as one PyTorch composition: adjoint_library on the NeRF
    encoding of the positions. Returns (fn, leaves): fn() -> (sdf, geo,
    grad)."""
    from multimodalstudio_tpu_torch.ops.encodings import nerf_encoding

    def encode(p):
        return nerf_encoding(p, kw["num_frequencies"], kw["min_freq_exp"], kw["max_freq_exp"])

    chain, leaves = adjoint_library(pos, ws, bs, kw["skip"], kw["beta"], encode, create_graph)

    def fn():
        h, grad = chain()
        return h[:, 0].float(), h[:, 1:], grad

    return fn, leaves


def check_sdf_chain(gen, dev):
    """K4's forward at one 1024-ray eval chunk's render samples: N=65536."""
    from multimodalstudio_tpu_torch.ops.kernels.sdf_chain import (
        fused_sdf_chain,
        fused_sdf_chain_plain,
    )

    n = 65536
    ws, bs = random_chain(gen, SDF_DIMS, dev)
    pos = torch.rand(n, 3, generator=gen, device=dev) * 2.2 - 1.1
    args = (pos, ws, bs)
    with torch.no_grad():
        out = fused_sdf_chain(*args, **SDF_KW)
        ref = fused_sdf_chain_plain(*args, **SDF_KW)
    torch.cuda.synchronize()
    err = _compare_outputs(f"K4 fwd N={n}", ("sdf", "geo", "grad"), out, ref)
    library, _ = sdf_library(pos, ws, bs, SDF_KW)
    with torch.no_grad():
        ms = time_ms(lambda: fused_sdf_chain(*args, **SDF_KW))
        plain_ms = time_ms(lambda: fused_sdf_chain_plain(*args, **SDF_KW))
    kernel_ms, ops = fwd_parts(f"K4 fwd N={n} (wrapper {ms:.3f} ms)",
                               lambda: fused_sdf_chain(*args, **SDF_KW), ADJ_FWD_KERNELS)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=time_ms(library),
                flops=sdf_flops(n, SDF_DIMS), bytes=nbytes(pos, ws, bs, out), err=err,
                kernel_ms=kernel_ms, ops=ops)


def sc_images(pos, ws, bs, pe):
    """The images K4's forward packs (backward images included), which its
    backward reuses on the main path."""
    from multimodalstudio_tpu_torch.ops.kernels.sdf_chain import _launch_fwd

    return _launch_fwd(pos, ws, bs, SDF_KW["skip"], SDF_KW["activation"], SDF_KW["beta"], pe)[3]


def adjoint_rows(n, n_layers):
    """Stacked rows of the adjoint backward's gW products: hin over qin
    below the last layer, hin alone at it."""
    return [2 * n] * (n_layers - 1) + [n]


def check_sdf_chain_bwd(gen, dev):
    """K4's training forward and its backward at one training microbatch's
    render samples: N=163840 (2560 rays x 64), cotangents on sdf, geo and
    grad; then the backward in its parts (stacked_backward_parts)."""
    from multimodalstudio_tpu_torch.ops.kernels.sdf_chain import (
        _launch_bwd,
        fused_sdf_chain,
        fused_sdf_chain_bwd_plain,
        fused_sdf_chain_plain,
        pe_scales,
        sdf_bwd_card,
    )

    n = 163840
    ws, bs = random_chain(gen, SDF_DIMS, dev)
    pos = torch.rand(n, 3, generator=gen, device=dev) * 2.2 - 1.1
    with torch.no_grad():
        out = fused_sdf_chain(pos, ws, bs, **SDF_KW)
        ref = fused_sdf_chain_plain(pos, ws, bs, **SDF_KW)
    fwd_err = _compare_outputs(f"K4 training fwd N={n}", ("sdf", "geo", "grad"), out, ref)
    gsdf = torch.randn(n, generator=gen, device=dev)
    ggeo = (0.1 * torch.randn(n, 256, generator=gen, device=dev)).to(torch.bfloat16)
    g3 = torch.randn(n, 3, generator=gen, device=dev)
    pe = pe_scales(6, 0.0, 5.0)
    kargs = (pos, ws, bs, SDF_KW["skip"], SDF_KW["activation"], SDF_KW["beta"], pe, gsdf, ggeo, g3)
    got = _launch_bwd(*kargs)
    want = fused_sdf_chain_bwd_plain(pos, ws, bs, gsdf, ggeo, g3, **SDF_KW)
    torch.cuda.synchronize()
    limits = _plain_conditioning(f"K4 bwd N={n}", CHAIN_GRADS, fused_sdf_chain_bwd_plain,
                                 lambda b: (pos, ws, b, gsdf, ggeo, g3), bs, SDF_KW, gen, dev, want)
    err = _compare_grads(f"K4 bwd N={n}", CHAIN_GRADS, got, want, tol=limits)
    fn, leaves = sdf_library(pos, ws, bs, SDF_KW, create_graph=True)
    outs = fn()
    cot = (gsdf, ggeo, g3)

    def library():
        return torch.autograd.grad(outs, leaves, cot, retain_graph=True)

    packed = sc_images(pos, ws, bs, pe)
    res = dict(ms=time_ms(lambda: _launch_bwd(*kargs, packed)),
               standalone_ms=time_ms(lambda: _launch_bwd(*kargs)),
               plain_ms=time_ms(lambda: fused_sdf_chain_bwd_plain(pos, ws, bs, gsdf, ggeo, g3,
                                                                  **SDF_KW)),
               library_ms=time_ms(library), flops=sdf_flops(n, SDF_DIMS, backward=True),
               bytes=nbytes(pos, ws, bs, gsdf, ggeo, g3, got[0], got[1], got[2]),
               err=err, fwd_err=fwd_err)
    res["wgrad"] = stacked_backward_parts(
        f"K4 bwd N={n}", lambda count: sdf_bwd_card(*kargs, count=count),
        lambda: _launch_bwd(*kargs, packed), adjoint_rows(n, len(SDF_DIMS)),
        old_atomics(n, SDF_DIMS, SDF_KW["skip"]), res)
    return res


# render samples of profile_step's default training microbatch: 1024 rays x 5 modalities x 64
PROFILE_N = 1024 * 5 * 64


def check_profile_microbatch(gen, dev, n=PROFILE_N):
    """K4's training forward and backward (its gW stacks 2N rows) and K1's mlp_raw_tpu trunk
    forward and backward at the render samples of profile_step's default microbatch, twice
    the 512-ray checks' N. Returns the max-abs errors by wrapper."""
    from multimodalstudio_tpu_torch.ops.kernels import fused_mlp, sdf_chain

    ws, bs = random_chain(gen, SDF_DIMS, dev)
    pos = torch.rand(n, 3, generator=gen, device=dev) * 2.2 - 1.1
    with torch.no_grad():
        out = sdf_chain.fused_sdf_chain(pos, ws, bs, **SDF_KW)
        ref = sdf_chain.fused_sdf_chain_plain(pos, ws, bs, **SDF_KW)
    errs = {"fused_sdf_chain": _compare_outputs(f"K4 training fwd N={n}", ("sdf", "geo", "grad"),
                                                out, ref)}
    del out, ref
    gsdf = torch.randn(n, generator=gen, device=dev)
    ggeo = (0.1 * torch.randn(n, 256, generator=gen, device=dev)).to(torch.bfloat16)
    g3 = torch.randn(n, 3, generator=gen, device=dev)
    got = sdf_chain._launch_bwd(pos, ws, bs, SDF_KW["skip"], SDF_KW["activation"], SDF_KW["beta"],
                                sdf_chain.pe_scales(6, 0.0, 5.0), gsdf, ggeo, g3)
    want = sdf_chain.fused_sdf_chain_bwd_plain(pos, ws, bs, gsdf, ggeo, g3, **SDF_KW)
    torch.cuda.synchronize()
    limits = _plain_conditioning(f"K4 bwd N={n}", CHAIN_GRADS, sdf_chain.fused_sdf_chain_bwd_plain,
                                 lambda b: (pos, ws, b, gsdf, ggeo, g3), bs, SDF_KW, gen, dev, want)
    errs["fused_sdf_chain_bwd"] = _compare_grads(f"K4 bwd N={n}", CHAIN_GRADS, got, want,
                                                 tol=limits)
    del got, want
    ws, bs = random_chain(gen, TRUNK_DIMS, dev)
    x = torch.rand(n, 285, generator=gen, device=dev) * 2 - 1
    kw = dict(skip=(4,), activation="ReLU")
    errs["fused_chain"] = _compare_outputs(
        f"K1 mlp_raw_tpu trunk N={n}", ("y",), (fused_mlp.fused_chain(x, ws, bs, **kw),),
        (fused_mlp.fused_chain_plain(x, ws, bs, **kw),))
    x = x.to(torch.bfloat16)
    gy = torch.randn(n, 256, generator=gen, device=dev).to(torch.bfloat16)
    got = fused_mlp._launch_bwd(x, gy, ws, bs, (4,), "ReLU", 100.0)
    want = fused_mlp.fused_chain_bwd_plain(x, gy, ws, bs, **kw)
    torch.cuda.synchronize()
    errs["fused_chain_bwd"] = _compare_grads(f"K1 bwd mlp_raw_tpu trunk N={n}", CHAIN_GRADS, got,
                                             want)
    return errs


def check_sdf_chain_edges(gen, dev) -> None:
    """K4 off the main path's shapes: a ragged N, ReLU (no act'' injections)
    with the skip at the last layer, forward and backward."""
    from multimodalstudio_tpu_torch.ops.kernels.sdf_chain import (
        _launch_bwd,
        fused_sdf_chain,
        fused_sdf_chain_bwd_plain,
        fused_sdf_chain_plain,
        pe_scales,
    )

    n = 1000
    relu_dims = [(39, 128), (128, 128), (128, 128), (167, 33)]
    for dims, kw in ((SDF_DIMS, SDF_KW), (relu_dims, dict(SDF_KW, skip=(3,), activation="ReLU"))):
        ws, bs = random_chain(gen, dims, dev)
        pos = torch.rand(n, 3, generator=gen, device=dev) * 2.2 - 1.1
        what = f"K4 {kw['activation']} skip={kw['skip']} N={n}"
        with torch.no_grad():
            _compare_outputs(what, ("sdf", "geo", "grad"), fused_sdf_chain(pos, ws, bs, **kw),
                             fused_sdf_chain_plain(pos, ws, bs, **kw))
        gsdf = torch.randn(n, generator=gen, device=dev)
        ggeo = torch.randn(n, dims[-1][1] - 1, generator=gen, device=dev).to(torch.bfloat16)
        g3 = torch.randn(n, 3, generator=gen, device=dev)
        got = _launch_bwd(pos, ws, bs, kw["skip"], kw["activation"], kw["beta"],
                          pe_scales(6, 0.0, 5.0), gsdf, ggeo, g3)
        want = fused_sdf_chain_bwd_plain(pos, ws, bs, gsdf, ggeo, g3, **kw)
        limits = 1e-2
        if dims is SDF_DIMS:
            # the 8-layer SoftplusQuad chain: the limit from its spread, the bias
            # moves drawn apart so that the later phases keep their inputs
            limits = _plain_conditioning(what + " bwd", CHAIN_GRADS, fused_sdf_chain_bwd_plain,
                                         lambda b: (pos, ws, b, gsdf, ggeo, g3), bs, kw,
                                         torch.Generator(device=dev).manual_seed(SEED), dev, want)
        _compare_grads(what + " bwd", CHAIN_GRADS, got, want, tol=limits)


def check_mlp_chains(gen, dev):
    """K1 at the mlp_raw_tpu chains: the forward of the 8-layer trunk (eval
    chunk, N=65536) and of the SDF chain as the sampler queries it (N=32768),
    and the backward of the trunk at one training microbatch (N=163840).
    Returns the trunk backward's timings."""
    from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import (
        _launch_bwd,
        fused_chain,
        fused_chain_bwd_plain,
        fused_chain_plain,
    )

    for name, n, dims, act in (("trunk", 65536, TRUNK_DIMS, "ReLU"),
                               ("SDF chain", 32768, SDF_DIMS, "SoftplusQuad")):
        ws, bs = random_chain(gen, dims, dev)
        x = torch.rand(n, dims[0][0], generator=gen, device=dev) * 2 - 1
        rel = rel_l2(fused_chain(x, ws, bs, skip=(4,), activation=act).float(),
                     fused_chain_plain(x, ws, bs, skip=(4,), activation=act).float())
        print(f"  K1 mlp_raw_tpu {name}: N={n} rel_l2={rel:.3e} (tolerance rel_l2 <= 1e-2)")
        if not rel <= 1e-2:
            fail(f"fused_chain disagrees with its plain version at the mlp_raw_tpu {name}")
        kw = dict(skip=(4,), activation=act)
        ms = time_ms(lambda: fused_chain(x, ws, bs, **kw))
        plain_ms = time_ms(lambda: fused_chain_plain(x, ws, bs, **kw))
        wb, bb = bf16_leaves(ws, bs, False)
        xb = x.to(torch.bfloat16)
        library_ms = time_ms(lambda: linear_chain(xb, wb, bb, skip=(4,), activation=act))
        kernel_ms, ops = k1_forward_parts(f"K1 mlp_raw_tpu {name}", x, ws, bs, kw)
        b_ms, b_by = bound(chain_flops(n, dims), nbytes(x, ws, bs) + 2 * n * dims[-1][1])
        print(f"  K1 mlp_raw_tpu {name} N={n}: wrapper {ms:.3f} ms, kernel alone {kernel_ms:.3f} ms, "
              f"{ops} device ops per call, plain {plain_ms:.3f} ms, library {library_ms:.3f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")
    n = 163840
    ws, bs = random_chain(gen, TRUNK_DIMS, dev)
    x = (torch.rand(n, 285, generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    gy = torch.randn(n, 256, generator=gen, device=dev).to(torch.bfloat16)
    args = (x, gy, ws, bs, (4,), "ReLU", 100.0)
    out = _launch_bwd(*args)
    ref = fused_chain_bwd_plain(x, gy, ws, bs, skip=(4,), activation="ReLU")
    torch.cuda.synchronize()
    err = _compare_grads(f"K1 bwd mlp_raw_tpu trunk N={n}", CHAIN_GRADS, out, ref)
    wb = [w.t().contiguous().to(torch.bfloat16).requires_grad_(True) for w in ws]
    bb = [b.to(torch.bfloat16).requires_grad_(True) for b in bs]
    xl = x.clone().requires_grad_(True)
    h = xl
    for l, (w, b) in enumerate(zip(wb, bb)):
        if l == 4:
            h = torch.cat([h, xl], dim=-1) * (2.0 ** -0.5)
        h = F.linear(h, w, b)
        if l < len(wb) - 1:
            h = torch.relu(h)

    def library():
        return torch.autograd.grad(h, [xl, *wb, *bb], gy, retain_graph=True)

    hidden = TRUNK_DIMS[:-1]
    ms, alone_ms = k1_backward_ms(x, gy, ws, bs, (4,), "ReLU")
    res = dict(ms=ms, standalone_ms=alone_ms,
               plain_ms=time_ms(lambda: fused_chain_bwd_plain(x, gy, ws, bs, skip=(4,),
                                                              activation="ReLU")),
               library_ms=time_ms(library),
               flops=chain_flops(n, hidden) + 2 * chain_flops(n, TRUNK_DIMS),
               bytes=k1_bwd_bytes(x, gy, ws, bs, out), err=err)
    res["err"] = max(err, k1_backward_parts(f"mlp_raw_tpu trunk N={n}", x, gy, ws, bs,
                                            dict(skip=(4,), activation="ReLU"), res))
    res.pop("parts")  # the kernels line times the parts at grid_raw_tpu's chains
    b_ms, b_by = bound(res["flops"], res["bytes"])
    print(f"  K1 bwd mlp_raw_tpu trunk N={n}: wrapper {res['ms']:.3f} ms with the forward's "
          f"images ({res['standalone_ms']:.3f} ms packing its own), kernel alone "
          f"{res['kernel_ms']:.3f} ms, {res['ops']} device ops per call, plain "
          f"{res['plain_ms']:.3f} ms, library {res['library_ms']:.3f} ms, bound {b_ms:.4f} ms "
          f"({b_by})")
    return res


# ---------------------------------------------------------------- K1t and K4j

TANGENT_GRADS = ("gx", "gtx", "gW", "gb")  # what K1t's backward returns


def tangent_flops(n, dims, k, t_in, t_out, backward=False):
    """Tensor-core flops of K1t and K4j: the primal chain, and each of the
    k tangents' chains through the hidden layers with their layer-0 product
    over the t_in input columns a tangent carries (K1t: all; K4j: the 1 + 2F
    nonzero columns of a basis tangent, whose own values cost no product)
    and only column c of the last layer (2 n din). Backward: the recompute
    of the hidden layers (primal and tangents), gW and gh of every primal
    layer and of the tangents' hidden layers, the tangents' gW at layer 0
    over t_in columns and gh over the t_out columns read (K1t's gtx: all;
    K4j's Hessian term: the 2F derivative columns of the coordinate), and
    the last layer's column c (gW and gh)."""
    h, last_in = dims[0][1], dims[-1][0]
    mid = chain_flops(n, dims[1:-1])
    fwd_tangents = k * (mid + 2.0 * n * t_in * h)
    if not backward:
        return chain_flops(n, dims) + fwd_tangents + k * 2.0 * n * last_in
    return (chain_flops(n, dims[:-1]) + fwd_tangents + 2 * chain_flops(n, dims)
            + k * (2 * mid + 2.0 * n * (t_in + t_out) * h + 2 * 2.0 * n * last_in))


def contraction_inputs(gen, dev, n):
    """The K1t chain input of n render samples on the contraction path:
    positions uniform in [-1.1, 1.1]^3, x = PE(contract(p)) and its
    tangents along the 3 axes (torch.func.jvp, as models/model.py takes
    them)."""
    from multimodalstudio_tpu_torch.ops.encodings import nerf_encoding
    from multimodalstudio_tpu_torch.ops.math import scene_contraction

    pos = torch.rand(n, 3, generator=gen, device=dev) * 2.2 - 1.1

    def enc(p):
        return nerf_encoding(scene_contraction(p, float("inf")), 6, 0.0, 5.0)

    eye = torch.eye(3, device=dev)
    pairs = [torch.func.jvp(enc, (pos,), (eye[k].expand_as(pos),)) for k in range(3)]
    return pairs[0][0], torch.stack([t for _, t in pairs])


def tangent_library(x, tx, ws, bs, skip=(), activation="SoftplusQuad", beta=100.0, encode=None,
                    create_graph=False):
    """One PyTorch composition computing the tangent chains' function:
    torch.func.jvp of the bf16 F.linear chain (cuBLAS) along each tangent,
    vmapped over the tangents (K4j: encode(x) in front and the 3 axes as
    tangents). Returns (fn, leaves): fn() -> (y bf16, d y_0 / d t [N, K])."""
    wb, bb = bf16_leaves(ws, bs, create_graph)
    p = (x.detach().clone() if encode else x.detach().to(torch.bfloat16)).requires_grad_(create_graph)
    if encode:
        eye = torch.eye(3, device=x.device)
        tp = eye[:, None, :].expand(3, *x.shape)
        leaves = [p, *wb, *bb]
    else:
        tp = tx.detach().to(torch.bfloat16).requires_grad_(create_graph)
        leaves = [p, tp, *wb, *bb]

    def chain(q):
        return linear_chain((encode(q) if encode else q).to(torch.bfloat16), wb, bb, skip,
                            activation, beta)

    def fn():
        y, ty = torch.func.vmap(lambda t: torch.func.jvp(chain, (p,), (t,)))(tp)
        return y[0], ty[:, :, 0].T.float()

    return fn, leaves


SPREAD_FLOOR = 1e-2  # the least limit of a check whose limit follows the plain version's spread


def _plain_conditioning(what, names, plain, args, bs, kw, gen, dev, ref):
    """How far the plain version moves with its biases moved by 1e-6
    (relative), as another f32 summation order moves z, printed per output;
    returns the limits the deep SoftplusQuad backward checks take from it:
    per output, max(SPREAD_FLOOR, twice that distance). A fixed 1e-2 sat
    inside the 8-layer backwards' own spread (1.1e-2 to 1.9e-2)."""
    moved = [b * (1 + 1e-6 * torch.randn(b.shape, generator=gen, device=dev)) for b in bs]
    limits = []
    for part, a, b in zip(names, plain(*args(moved), **kw), ref):
        spread = rel_l2(_flat(a), _flat(b))
        limits.append(max(SPREAD_FLOOR, 2 * spread))
        print(f"  {what}, plain vs plain with biases moved by 1e-6: {part} rel_l2={spread:.3e} "
              f"(limit of the check from it: {limits[-1]:.3e})")
    return limits


TANGENT_KW = dict(skip=(4,), activation="SoftplusQuad", beta=100.0, tangent_out_channel=0)


def check_chain_tangents(gen, dev):
    """K1t's forward at one 1024-ray eval chunk's render samples on the
    contraction path (N=65536, the 8 x 256 SDF chain, 3 tangents, the sdf
    channel's tangents out), and at one training microbatch's (N=163840)."""
    from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import fused_chain, fused_chain_plain

    ws, bs = random_chain(gen, SDF_DIMS, dev)
    err = 0.0
    for n in (163840, 65536):
        x, tx = contraction_inputs(gen, dev, n)
        with torch.no_grad():
            out = fused_chain(x, ws, bs, tangents=tx, **TANGENT_KW)
            ref = fused_chain_plain(x, ws, bs, tangents=tx, **TANGENT_KW)
        torch.cuda.synchronize()
        err = max(err, _compare_outputs(f"K1t fwd N={n}", ("y", "ty"), out, ref))
    _plain_conditioning(f"K1t fwd N={n}", ("y", "ty"), fused_chain_plain,
                        lambda b: (x, ws, b), bs, dict(TANGENT_KW, tangents=tx), gen, dev, ref)
    library, _ = tangent_library(x, tx, ws, bs, skip=(4,))
    with torch.no_grad():
        ms = time_ms(lambda: fused_chain(x, ws, bs, tangents=tx, **TANGENT_KW))
        plain_ms = time_ms(lambda: fused_chain_plain(x, ws, bs, tangents=tx, **TANGENT_KW))
        library_ms = time_ms(library)
    kernel_ms, ops = fwd_parts(f"K1t fwd N={n} (wrapper {ms:.3f} ms)",
                               lambda: fused_chain(x, ws, bs, tangents=tx, **TANGENT_KW),
                               TAN_FWD_KERNELS)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                flops=tangent_flops(n, SDF_DIMS, 3, 39, 39), bytes=nbytes(x, tx, ws, bs, out),
                err=err, kernel_ms=kernel_ms, ops=ops)


def check_chain_tangents_bwd(gen, dev):
    """K1t's backward at one training microbatch's render samples on the
    contraction path: N=163840, cotangents on y (bf16) and the sdf
    channel's tangents (f32); then the backward in its parts
    (stacked_backward_parts)."""
    from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import (
        _launch_tangent_bwd,
        _launch_tangent_fwd,
        fused_chain_tangent_bwd_plain,
        tangent_bwd_card,
    )

    n = 163840
    ws, bs = random_chain(gen, SDF_DIMS, dev)
    x, tx = contraction_inputs(gen, dev, n)
    gy = (0.1 * torch.randn(n, 257, generator=gen, device=dev)).to(torch.bfloat16)
    gty = torch.randn(n, 3, generator=gen, device=dev)
    kargs = (x, tx, gy, gty, ws, bs, (4,), "SoftplusQuad", 100.0, 0)
    plain_kw = dict(skip=(4,), activation="SoftplusQuad", tangent_out_channel=0)
    got = _launch_tangent_bwd(*kargs)
    want = fused_chain_tangent_bwd_plain(x, tx, gy, gty, ws, bs, **plain_kw)
    torch.cuda.synchronize()
    limits = _plain_conditioning(f"K1t bwd N={n}", TANGENT_GRADS, fused_chain_tangent_bwd_plain,
                                 lambda b: (x, tx, gy, gty, ws, b), bs, plain_kw, gen, dev, want)
    err = _compare_grads(f"K1t bwd N={n}", TANGENT_GRADS, got, want, tol=limits)
    fn, leaves = tangent_library(x, tx, ws, bs, skip=(4,), create_graph=True)
    outs = fn()

    def library():
        return torch.autograd.grad(outs, leaves, (gy, gty), retain_graph=True)

    packed = _launch_tangent_fwd(*kargs[:2], *kargs[4:], backward_images=True)[2]
    res = dict(ms=time_ms(lambda: _launch_tangent_bwd(*kargs, packed)),
               standalone_ms=time_ms(lambda: _launch_tangent_bwd(*kargs)),
               plain_ms=time_ms(lambda: fused_chain_tangent_bwd_plain(
                   x, tx, gy, gty, ws, bs, **plain_kw)),
               library_ms=time_ms(library),
               flops=tangent_flops(n, SDF_DIMS, 3, 39, 39, backward=True),
               bytes=nbytes(x, tx, gy, gty, ws, bs, got[0], got[1], got[2], got[3]), err=err)
    res["wgrad"] = stacked_backward_parts(
        f"K1t bwd N={n}", lambda count: tangent_bwd_card(*kargs, count=count),
        lambda: _launch_tangent_bwd(*kargs, packed), [4 * n] * len(SDF_DIMS),
        old_atomics(n, SDF_DIMS, (4,), k=3), res)
    return res


def sdf_encode(kw):
    from multimodalstudio_tpu_torch.ops.encodings import nerf_encoding

    return lambda p: nerf_encoding(p, kw["num_frequencies"], kw["min_freq_exp"],
                                   kw["max_freq_exp"])


def check_sdf_chain_jvp(gen, dev):
    """K4j's forward at one 1024-ray eval chunk's render samples (N=65536)
    and one training microbatch's (N=163840), on the mlp_raw_tpu SDF
    chain."""
    from multimodalstudio_tpu_torch.ops.kernels.sdf_chain import (
        fused_sdf_chain,
        fused_sdf_chain_jvp_plain,
    )

    ws, bs = random_chain(gen, SDF_DIMS, dev)
    err = 0.0
    for n in (163840, 65536):
        pos = torch.rand(n, 3, generator=gen, device=dev) * 2.2 - 1.1
        with torch.no_grad():
            out = fused_sdf_chain(pos, ws, bs, mode="jvp", **SDF_KW)
            ref = fused_sdf_chain_jvp_plain(pos, ws, bs, **SDF_KW)
        torch.cuda.synchronize()
        err = max(err, _compare_outputs(f"K4j fwd N={n}", ("sdf", "geo", "grad"), out, ref))
    _plain_conditioning(f"K4j fwd N={n}", ("sdf", "geo", "grad"), fused_sdf_chain_jvp_plain,
                        lambda b: (pos, ws, b), bs, SDF_KW, gen, dev, ref)
    chain, _ = tangent_library(pos, None, ws, bs, skip=(4,), encode=sdf_encode(SDF_KW))

    def library():
        y, grad = chain()
        return y[:, 0].float(), y[:, 1:], grad

    with torch.no_grad():
        ms = time_ms(lambda: fused_sdf_chain(pos, ws, bs, mode="jvp", **SDF_KW))
        plain_ms = time_ms(lambda: fused_sdf_chain_jvp_plain(pos, ws, bs, **SDF_KW))
        library_ms = time_ms(library)
    kernel_ms, ops = fwd_parts(f"K4j fwd N={n} (wrapper {ms:.3f} ms)",
                               lambda: fused_sdf_chain(pos, ws, bs, mode="jvp", **SDF_KW),
                               TAN_FWD_KERNELS)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                flops=tangent_flops(n, SDF_DIMS, 3, 13, 12), bytes=nbytes(pos, ws, bs, out),
                err=err, kernel_ms=kernel_ms, ops=ops)


def check_sdf_chain_jvp_bwd(gen, dev):
    """K4j's backward at one training microbatch's render samples:
    N=163840, cotangents on sdf, geo and grad; then the backward in its
    parts (stacked_backward_parts)."""
    from multimodalstudio_tpu_torch.ops.kernels.sdf_chain import (
        _launch_jvp_bwd,
        _launch_jvp_fwd,
        fused_sdf_chain_jvp_bwd_plain,
        jvp_bwd_card,
        pe_scales,
    )

    n = 163840
    ws, bs = random_chain(gen, SDF_DIMS, dev)
    pos = torch.rand(n, 3, generator=gen, device=dev) * 2.2 - 1.1
    gsdf = torch.randn(n, generator=gen, device=dev)
    ggeo = (0.1 * torch.randn(n, 256, generator=gen, device=dev)).to(torch.bfloat16)
    g3 = torch.randn(n, 3, generator=gen, device=dev)
    kargs = (pos, ws, bs, SDF_KW["skip"], SDF_KW["activation"], SDF_KW["beta"],
             pe_scales(6, 0.0, 5.0), gsdf, ggeo, g3)
    got = _launch_jvp_bwd(*kargs)
    want = fused_sdf_chain_jvp_bwd_plain(pos, ws, bs, gsdf, ggeo, g3, **SDF_KW)
    torch.cuda.synchronize()
    limits = _plain_conditioning(f"K4j bwd N={n}", CHAIN_GRADS, fused_sdf_chain_jvp_bwd_plain,
                                 lambda b: (pos, ws, b, gsdf, ggeo, g3), bs, SDF_KW, gen, dev, want)
    err = _compare_grads(f"K4j bwd N={n}", CHAIN_GRADS, got, want, tol=limits)
    chain, leaves = tangent_library(pos, None, ws, bs, skip=(4,), encode=sdf_encode(SDF_KW),
                                    create_graph=True)
    y, grad = chain()
    outs = (y[:, 0].float(), y[:, 1:], grad)

    def library():
        return torch.autograd.grad(outs, leaves, (gsdf, ggeo, g3), retain_graph=True)

    packed = _launch_jvp_fwd(*kargs[:7], backward_images=True)[3]
    res = dict(ms=time_ms(lambda: _launch_jvp_bwd(*kargs, packed)),
               standalone_ms=time_ms(lambda: _launch_jvp_bwd(*kargs)),
               plain_ms=time_ms(lambda: fused_sdf_chain_jvp_bwd_plain(pos, ws, bs, gsdf, ggeo,
                                                                      g3, **SDF_KW)),
               library_ms=time_ms(library),
               flops=tangent_flops(n, SDF_DIMS, 3, 13, 12, backward=True),
               bytes=nbytes(pos, ws, bs, gsdf, ggeo, g3, got[0], got[1], got[2]), err=err)
    res["wgrad"] = stacked_backward_parts(
        f"K4j bwd N={n}", lambda count: jvp_bwd_card(*kargs, count=count),
        lambda: _launch_jvp_bwd(*kargs, packed), [4 * n] * len(SDF_DIMS),
        old_atomics(n, SDF_DIMS, (4,), k=3), res)
    return res


def check_tangent_edges(gen, dev) -> None:
    """K1t and K4j off the main path's shapes: a ragged N; a short chain with
    a skip and the full ty [K, N, D_out] bf16; ReLU (no act'' term) with one
    tangent (32-sample tiles) and with two (16-sample tiles, 16 idle rows)
    at channel 1; K4j with ReLU and the skip at the last layer; forward and
    backward."""
    from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import (
        _launch_tangent_bwd,
        fused_chain,
        fused_chain_plain,
        fused_chain_tangent_bwd_plain,
    )
    from multimodalstudio_tpu_torch.ops.kernels.sdf_chain import (
        _launch_jvp_bwd,
        fused_sdf_chain,
        fused_sdf_chain_jvp_bwd_plain,
        fused_sdf_chain_jvp_plain,
        pe_scales,
    )

    n = 1000
    cases = (("SoftplusQuad", (2,), [(39, 128), (128, 128), (167, 128), (128, 17)], 3, None),
             ("ReLU", (), [(39, 128), (128, 33)], 1, 1),
             ("ReLU", (), [(39, 128), (128, 128), (128, 33)], 2, 1))
    for act, skip, dims, k, channel in cases:
        ws, bs = random_chain(gen, dims, dev)
        x = torch.rand(n, 39, generator=gen, device=dev) * 2 - 1
        tx = torch.randn(k, n, 39, generator=gen, device=dev)
        kw = dict(skip=skip, activation=act, beta=100.0, tangent_out_channel=channel)
        what = f"K1t {act} skip={skip} K={k} channel={channel} N={n}"
        with torch.no_grad():
            _compare_outputs(what, ("y", "ty"), fused_chain(x, ws, bs, tangents=tx, **kw),
                             fused_chain_plain(x, ws, bs, tangents=tx, **kw))
        gy = torch.randn(n, dims[-1][1], generator=gen, device=dev).to(torch.bfloat16)
        gty = (torch.randn(n, k, generator=gen, device=dev) if channel is not None else
               torch.randn(k, n, dims[-1][1], generator=gen, device=dev).to(torch.bfloat16))
        _compare_grads(what + " bwd", TANGENT_GRADS,
                       _launch_tangent_bwd(x, tx, gy, gty, ws, bs, skip, act, 100.0, channel),
                       fused_chain_tangent_bwd_plain(x, tx, gy, gty, ws, bs, skip=skip,
                                                     activation=act, tangent_out_channel=channel))
    dims = [(39, 128), (128, 128), (128, 128), (167, 33)]
    kw = dict(SDF_KW, skip=(3,), activation="ReLU")
    ws, bs = random_chain(gen, dims, dev)
    pos = torch.rand(n, 3, generator=gen, device=dev) * 2.2 - 1.1
    what = f"K4j ReLU skip=(3,) N={n}"
    with torch.no_grad():
        _compare_outputs(what, ("sdf", "geo", "grad"), fused_sdf_chain(pos, ws, bs, mode="jvp", **kw),
                         fused_sdf_chain_jvp_plain(pos, ws, bs, **kw))
    gsdf = torch.randn(n, generator=gen, device=dev)
    ggeo = torch.randn(n, 32, generator=gen, device=dev).to(torch.bfloat16)
    g3 = torch.randn(n, 3, generator=gen, device=dev)
    _compare_grads(what + " bwd", CHAIN_GRADS,
                   _launch_jvp_bwd(pos, ws, bs, (3,), "ReLU", 100.0, pe_scales(6, 0.0, 5.0), gsdf,
                                   ggeo, g3),
                   fused_sdf_chain_jvp_bwd_plain(pos, ws, bs, gsdf, ggeo, g3, **kw))


def check_wide_hidden(gen, dev, widths=(384, 512)) -> None:
    """Hidden widths that JAX's can_fuse sends to its fused kernels, 384 and
    512 (csrc/k1.cuh WC_WIDE) or 640, 768 and 1024 (WC_DEV, the activation
    images in device memory): K1 forward and backward (a skip chain, and at
    384 a chain of 20,000 rows, where two consumer warpgroups share a CTA),
    and the K4, K5, K1t and K4j backwards (their per-tile passes and
    chain_wgrad), each against its plain version on a ragged N; past 512
    also K2's forward and K3's backward pass, merged and split (check_slot_wide).
    The SoftplusQuad backwards' limits follow their plain versions' spread,
    from a generator of their own, as the deep chains' do. Past 512 those
    backwards (K1's, K4's, K4j's, K5's, K1t's) are printed beside that limit
    but held by check_padded_widths, bit for bit against the 512-wide
    kernels: the card's f32 summation order moves z by more at these depths
    of product than the spread's 1e-6 bias move does (ROADMAP queue 3, item
    1): the printed distance reached 1.12 times the limit at 768 and 1024
    on some draws while the padded check held bit for bit."""
    from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import (
        _launch_bwd,
        _launch_tangent_bwd,
        fused_chain,
        fused_chain_bwd_plain,
        fused_chain_plain,
        fused_chain_tangent_bwd_plain,
    )
    from multimodalstudio_tpu_torch.ops.kernels.sdf_chain import (
        _launch_adj_bwd,
        _launch_bwd as _launch_sdf_bwd,
        _launch_jvp_bwd,
        fused_chain_adjoint_bwd_plain,
        fused_sdf_chain_bwd_plain,
        fused_sdf_chain_jvp_bwd_plain,
        pe_scales,
    )

    spread_gen = torch.Generator(device=dev).manual_seed(SEED)

    def limits(what, names, plain, args, bs, kw, ref):
        if kw.get("activation") != "SoftplusQuad":
            return 1e-2
        return _plain_conditioning(what, names, plain, args, bs, kw, spread_gen, dev, ref)

    def held(what, names, out, ref, tol, act, h):
        if h > 512 and act == "SoftplusQuad":
            _report_grads(what, names, out, ref, tol)
        else:
            _compare_grads(what, names, out, ref, tol=tol)

    n, pe = 1000, pe_scales(6, 0.0, 5.0)
    for h in widths:
        # K1: a SoftplusQuad chain with a skip, and a ReLU one
        for act, skip, dims, rows in (
                ("SoftplusQuad", (2,), [(39, h), (h, h), (h + 39, h), (h, 65)], n),
                ("ReLU", (), [(285, h), (h, h), (h, 3)], 20000 if h == 384 else n)):
            ws, bs = random_chain(gen, dims, dev)
            x = torch.rand(rows, dims[0][0], generator=gen, device=dev) * 2 - 1
            kw = dict(skip=skip, activation=act)
            what = f"K1 H={h} {act} skip={skip} N={rows}"
            rel = rel_l2(fused_chain(x, ws, bs, **kw).float(),
                         fused_chain_plain(x, ws, bs, **kw).float())
            print(f"  {what}: rel_l2={rel:.3e} (tolerance rel_l2 <= 1e-2)")
            if not rel <= 1e-2:
                fail(f"fused_chain disagrees with its plain version at {what}")
            gy = torch.randn(rows, dims[-1][1], generator=gen, device=dev)
            ref = fused_chain_bwd_plain(x, gy, ws, bs, **kw)
            tol = limits(what + " bwd", CHAIN_GRADS, fused_chain_bwd_plain,
                         lambda b: (x, gy, ws, b), bs, kw, ref)
            held(what + " bwd", CHAIN_GRADS, _launch_bwd(x, gy, ws, bs, skip, act, 100.0), ref,
                 tol, act, h)
        wide_forwards(dev, h)
        dims = [(39, h), (h, h), (h + 39, h), (h, 257)]
        # K4 (adjoint, the encoding in front)
        ws, bs = random_chain(gen, dims, dev)
        pos = torch.rand(n, 3, generator=gen, device=dev) * 2.2 - 1.1
        gsdf = torch.randn(n, generator=gen, device=dev)
        ggeo = torch.randn(n, 256, generator=gen, device=dev).to(torch.bfloat16)
        g3 = torch.randn(n, 3, generator=gen, device=dev)
        kw = dict(SDF_KW, skip=(2,))
        what = f"K4 bwd H={h} skip=(2,) N={n}"
        ref = fused_sdf_chain_bwd_plain(pos, ws, bs, gsdf, ggeo, g3, **kw)
        tol = limits(what, CHAIN_GRADS, fused_sdf_chain_bwd_plain,
                     lambda b: (pos, ws, b, gsdf, ggeo, g3), bs, kw, ref)
        held(what, CHAIN_GRADS, _launch_sdf_bwd(pos, ws, bs, (2,), "SoftplusQuad", 100.0, pe, gsdf,
                                                ggeo, g3), ref, tol, "SoftplusQuad", h)
        # K4j (jvp mode)
        what = f"K4j bwd H={h} skip=(2,) N={n}"
        ref = fused_sdf_chain_jvp_bwd_plain(pos, ws, bs, gsdf, ggeo, g3, **kw)
        tol = limits(what, CHAIN_GRADS, fused_sdf_chain_jvp_bwd_plain,
                     lambda b: (pos, ws, b, gsdf, ggeo, g3), bs, kw, ref)
        held(what, CHAIN_GRADS, _launch_jvp_bwd(pos, ws, bs, (2,), "SoftplusQuad", 100.0, pe, gsdf,
                                                ggeo, g3), ref, tol, "SoftplusQuad", h)
        # K5 (adjoint of an encoded input) at channel 1
        dims = [(15, h), (h, h), (h + 15, h), (h, 33)]
        ws, bs = random_chain(gen, dims, dev)
        x = torch.rand(n, 15, generator=gen, device=dev) * 2 - 1
        gy = torch.randn(n, 33, generator=gen, device=dev).to(torch.bfloat16)
        ga = torch.randn(n, 15, generator=gen, device=dev)
        kw = dict(skip=(2,), activation="SoftplusQuad", beta=100.0, channel=1)
        what = f"K5 bwd H={h} skip=(2,) channel 1 N={n}"
        ref = fused_chain_adjoint_bwd_plain(x, ws, bs, gy, ga, **kw)
        tol = limits(what, CHAIN_GRADS, fused_chain_adjoint_bwd_plain,
                     lambda b: (x, ws, b, gy, ga), bs, kw, ref)
        held(what, CHAIN_GRADS, _launch_adj_bwd(x, ws, bs, (2,), "SoftplusQuad", 100.0, 1, gy, ga),
             ref, tol, "SoftplusQuad", h)
        # K1t (forward tangents), 3 tangents on channel 0, and the full ty with 2
        for k, channel in ((3, 0), (2, None)):
            dims = [(39, h), (h, h), (h + 39, h), (h, 17)]
            ws, bs = random_chain(gen, dims, dev)
            x = torch.rand(n, 39, generator=gen, device=dev) * 2 - 1
            tx = torch.randn(k, n, 39, generator=gen, device=dev)
            gy = torch.randn(n, 17, generator=gen, device=dev).to(torch.bfloat16)
            gty = (torch.randn(n, k, generator=gen, device=dev) if channel is not None else
                   torch.randn(k, n, 17, generator=gen, device=dev).to(torch.bfloat16))
            kw = dict(skip=(2,), activation="SoftplusQuad", beta=100.0,
                      tangent_out_channel=channel)
            what = f"K1t bwd H={h} skip=(2,) K={k} channel={channel} N={n}"
            ref = fused_chain_tangent_bwd_plain(x, tx, gy, gty, ws, bs, **kw)
            tol = limits(what, TANGENT_GRADS, fused_chain_tangent_bwd_plain,
                         lambda b: (x, tx, gy, gty, ws, b), bs, kw, ref)
            held(what, TANGENT_GRADS, _launch_tangent_bwd(x, tx, gy, gty, ws, bs, (2,),
                                                          "SoftplusQuad", 100.0, channel),
                 ref, tol, "SoftplusQuad", h)
        if h > 512:
            check_slot_wide(gen, dev, h)
    if any(h > 512 for h in widths):
        check_padded_widths(dev, [h for h in widths if h > 512])


def wide_forwards(dev, h) -> None:
    """The adjoint and tangent forwards at hidden width h against their plain
    versions (rel-L2 1e-2) on a ragged N = 1000, SoftplusQuad chains with a
    skip at layer 2, drawn from a generator of their own: K4 and K4j (the
    encoding in front, 257 outputs), K5 (15 inputs, 33 outputs, channel 1)
    and K1t (39 inputs, 17 outputs; 3 tangents on channel 0, and 2 with the
    full ty)."""
    from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import fused_chain, fused_chain_plain
    from multimodalstudio_tpu_torch.ops.kernels.sdf_chain import (
        fused_chain_adjoint,
        fused_chain_adjoint_plain,
        fused_sdf_chain,
        fused_sdf_chain_jvp_plain,
        fused_sdf_chain_plain,
    )

    g = torch.Generator(device=dev).manual_seed(SEED + 5 * h)
    n, kw = 1000, dict(SDF_KW, skip=(2,))
    ws, bs = random_chain(g, [(39, h), (h, h), (h + 39, h), (h, 257)], dev)
    pos = torch.rand(n, 3, generator=g, device=dev) * 2.2 - 1.1
    ws5, bs5 = random_chain(g, [(15, h), (h, h), (h + 15, h), (h, 33)], dev)
    x5 = torch.rand(n, 15, generator=g, device=dev) * 2 - 1
    wst, bst = random_chain(g, [(39, h), (h, h), (h + 39, h), (h, 17)], dev)
    x = torch.rand(n, 39, generator=g, device=dev) * 2 - 1
    tkw = dict(skip=(2,), activation="SoftplusQuad", beta=100.0)
    with torch.no_grad():
        cases = [
            ("K4", ("sdf", "geo", "grad"), fused_sdf_chain(pos, ws, bs, **kw),
             fused_sdf_chain_plain(pos, ws, bs, **kw)),
            ("K4j", ("sdf", "geo", "grad"), fused_sdf_chain(pos, ws, bs, mode="jvp", **kw),
             fused_sdf_chain_jvp_plain(pos, ws, bs, **kw)),
            ("K5 channel 1", ("y", "adj"), fused_chain_adjoint(x5, ws5, bs5, skip=(2,), channel=1),
             fused_chain_adjoint_plain(x5, ws5, bs5, skip=(2,), channel=1)),
        ]
        for k, channel in ((3, 0), (2, None)):
            tx = torch.randn(k, n, 39, generator=g, device=dev)
            tk = dict(tkw, tangents=tx, tangent_out_channel=channel)
            cases.append((f"K1t K={k} channel={channel}", ("y", "ty"), fused_chain(x, wst, bst, **tk),
                          fused_chain_plain(x, wst, bst, **tk)))
    torch.cuda.synchronize()
    for name, names, out, ref in cases:
        _compare_outputs(f"{name} fwd H={h} skip=(2,) N={n}", names, out, ref)


def check_slot_wide(gen, dev, h) -> None:
    """The slot kernels at hidden width h on grid_raw_tpu's grid (6 levels of
    4096 rows, F = 2, 3 active) at a ragged N = 1000, the chain 51 -> h -> h
    -> 257 SoftplusQuad: K2's forward (training mode) and backward, merged
    and split, and K3's forward (training mode) and backward, merged and
    split, each backward on its own forward's residuals and held against
    its plain version on those residuals (a rounding of the forward that
    differs from the plain forward's moves the backward of that row, K3f's
    d pos at 1024 by 2.5e-2 once), its limits following the plain version's
    spread; then the same for K2f and K3f on the f32 table's grid (6 x 512,
    F = 16), drawn from a generator of their own."""
    from multimodalstudio_tpu_torch.ops.kernels.slot_grid import SlotGridSpec

    gspec = SlotGridSpec(num_levels=6, min_res=16, max_res=512, rows_per_level=4096,
                         layout="cell", feats=2, table_dtype="bf16")
    slot_wide_checks(gen, dev, h, gspec)
    slot_wide_checks(torch.Generator(device=dev).manual_seed(SEED + h), dev, h, f32_spec())


def slot_wide_checks(gen, dev, h, gspec) -> None:
    """check_slot_wide on one grid."""
    from multimodalstudio_tpu_torch.ops.kernels.slot_fused import (
        _chain_fwd_plain,
        _chain_split_card,
        _launch,
        _launch_chain_bwd,
        _launch_value_bwd,
        _value_fwd_plain,
        _value_split_card,
        pe_scales,
        slot_sdf_chain_bwd_plain,
        slot_sdf_chain_bwd_split_plain,
        slot_sdf_value_bwd_plain,
        slot_sdf_value_bwd_split_plain,
    )

    n, pe = 1000, pe_scales(6, 0.0, 5.0)
    k2, k3 = slot_tag("K2", gspec), slot_tag("K3", gspec)
    table, _, _ = slot_inputs(gen, dev, gspec)
    ws, bs = random_chain(gen, [(slot_d_in(gspec), h), (h, h), (h, 257)], dev)
    pos = torch.rand(n, 3, generator=gen, device=dev) * 2.2 - 1.1
    mask = (torch.arange(gspec.out_dim, device=dev) < 3 * gspec.feats).float()
    fwd = (pos, table, ws, bs, gspec, gspec.num_levels, 1.0, pe, "SoftplusQuad", 100.0, mask)
    sdf, _, _, zs, _, _, x0 = _launch(*fwd, False, resid=True, x0=True)
    sdf_p, zs_p, x0_p = _value_fwd_plain(*fwd)
    _compare_outputs(f"{k2} training fwd H={h} N={n}", ("sdf", "zs", "x0"),
                     (sdf, zs, x0[:, :x0_p.shape[1]]), (sdf_p, zs_p, x0_p))
    cfwd = (pos, table, ws, bs, gspec, 1.0, pe, "SoftplusQuad", 100.0, mask)
    gsdf = torch.randn(n, generator=gen, device=dev)
    ggeo = (0.1 * torch.randn(n, 256, generator=gen, device=dev)).to(torch.bfloat16)
    g3 = torch.randn(n, 3, generator=gen, device=dev)
    cot = (gsdf, ggeo, g3)
    kw = dict(SLOT_KW, level_mask=mask)
    spread = torch.Generator(device=dev).manual_seed(SEED)

    def vplain(b):
        """The plain forward with biases b, then K2's plain backward."""
        zs_b = _value_fwd_plain(pos, table, ws, b, *fwd[4:])[1]
        return slot_sdf_value_bwd_plain(pos, table, ws, b, gspec, zs_b, gsdf, **kw)

    # each backward against its plain version on the same residuals, the card forward's
    what = f"{k2} bwd H={h} N={n}"
    tol = _plain_conditioning(what, SLOT_GRADS, vplain, lambda b: (b,), bs, {}, spread, dev,
                              vplain(bs))
    merged = _launch_value_bwd(*fwd, zs, gsdf)
    _compare_grads(what, SLOT_GRADS, merged,
                   slot_sdf_value_bwd_plain(pos, table, ws, bs, gspec, zs, gsdf, **kw), tol=tol)
    split = _value_split_card(*fwd, zs, gsdf)
    _compare_grads(f"{k2}s whole split backward H={h} N={n}", SLOT_GRADS, split,
                   slot_sdf_value_bwd_split_plain(pos, table, ws, bs, gspec, zs, x0, gsdf,
                                                  **kw), tol=tol)
    _compare_grads(f"{k2}s whole split backward vs merged H={h} N={n}", SLOT_GRADS[:2], split[:2],
                   merged[:2], tol=1e-5)
    _compare_grads(f"{k2}s whole split backward vs merged H={h} N={n}", SLOT_GRADS[2:], split[2:],
                   merged[2:], tol=2e-2)
    # K3's forward on the card, and its backward on that forward's residuals
    out_k = _launch(*fwd, True, resid=True)
    outs_p, (zs_p, ss_p, adj_p, x0_p) = _chain_fwd_plain(*cfwd)
    _compare_outputs(f"{k3} training fwd H={h} N={n}", ("sdf", "geo", "grad", "zs", "ss", "adj"),
                     out_k[:6], (*outs_p, zs_p, ss_p, adj_p))

    def plain(b):
        """The plain forward with biases b, then K3's plain backward."""
        resid = _chain_fwd_plain(pos, table, ws, b, *cfwd[4:])[1][:3]
        return slot_sdf_chain_bwd_plain(pos, table, ws, b, gspec, *resid, *cot, **kw)

    what = f"{k3} bwd H={h} N={n}"
    tol = _plain_conditioning(what, SLOT_GRADS, plain, lambda b: (b,), bs, {}, spread, dev,
                              plain(bs))
    merged = _launch_chain_bwd(*cfwd, *out_k[3:6], *cot)
    _compare_grads(what, SLOT_GRADS, merged,
                   slot_sdf_chain_bwd_plain(pos, table, ws, bs, gspec, *out_k[3:6], *cot, **kw),
                   tol=tol)
    split = _chain_split_card(*cfwd, *out_k[3:6], *cot)
    _compare_grads(f"{k3}s whole split backward H={h} N={n}", SLOT_GRADS, split,
                   slot_sdf_chain_bwd_split_plain(pos, table, ws, bs, gspec, *out_k[3:6], x0_p,
                                                  *cot, **kw), tol=tol)
    _compare_grads(f"{k3}s whole split backward vs merged H={h} N={n}", SLOT_GRADS[:2], split[:2],
                   merged[:2], tol=1e-5)
    _compare_grads(f"{k3}s whole split backward vs merged H={h} N={n}", SLOT_GRADS[2:], split[2:],
                   merged[2:], tol=2e-2)


LIVE = 512  # the live hidden width of check_padded_widths' chains


def pad_chain(ws, bs, skip, h, high):
    """A chain of hidden width h that computes what (ws, bs), of hidden
    width LIVE, computes: the live units at columns [0, LIVE), or with `high`
    at [h - LIVE, h), the others dead (no weight in or out and bias -1, where
    SoftplusQuad and its derivatives are 0), a skip layer's x0 rows after
    the h rows."""
    o, n_layers = (h - LIVE if high else 0), len(ws)
    out_w, out_b = [], []
    for l, (w, b) in enumerate(zip(ws, bs)):
        last = l == n_layers - 1
        rows = w.shape[0] if l == 0 else h + (w.shape[0] - LIVE)
        cols = slice(None) if last else slice(o, o + LIVE)
        wl = w.new_zeros(rows, w.shape[1] if last else h)
        bl = b.clone() if last else b.new_full((h,), -1.0)
        if l == 0:
            wl[:, cols] = w
        else:
            wl[o:o + LIVE, cols] = w[:LIVE]
            wl[h:, cols] = w[LIVE:]
        if not last:
            bl[o:o + LIVE] = b
        out_w.append(wl)
        out_b.append(bl)
    return out_w, out_b


def unpad_grads(gws, gbs, skip, h, high):
    """pad_chain's gW and gb cut back to the live chain's."""
    o, n_layers = (h - LIVE if high else 0), len(gws)
    ws, bs = [], []
    for l, (g, gb) in enumerate(zip(gws, gbs)):
        last = l == n_layers - 1
        cols = slice(None) if last else slice(o, o + LIVE)
        rows = g if l == 0 else torch.cat([g[o:o + LIVE], g[h:]])
        ws.append(rows[:, cols])
        bs.append(gb[cols])
    return ws, bs


def check_padded_widths(dev, widths) -> None:
    """The device-memory width class (csrc/k1.cuh WC_DEV) against the
    512-wide kernels (WC_WIDE) on the same function: each chain of hidden
    width 512 padded to h with dead units (pad_chain), its live units first
    or last, so that every piece position carries live columns. The products
    then add exact zeros to the same partial sums: every forward's outputs
    and the backwards' per-row outputs (gx, gtx, d pos) must equal the
    512-wide kernels' bit for bit, and gW, gb and the table gradient, summed
    by atomics in an order that changes from run to run, within rel-L2 1e-5.
    Covers K1 forward and backward, K1t forward (3 tangents on a channel, 2
    with the full ty) and backward (2 tangents, the full ty), K4, K4j and K5
    forward and backward, and on both tables K2's and K3's forwards and
    backwards, merged and split, on a ragged N = 1000 (skip chains but the
    slot chains', SoftplusQuad). Draws from a generator of its own."""
    from multimodalstudio_tpu_torch.ops.kernels import fused_mlp as fm
    from multimodalstudio_tpu_torch.ops.kernels import sdf_chain as sc
    from multimodalstudio_tpu_torch.ops.kernels import slot_fused as sf
    from multimodalstudio_tpu_torch.ops.kernels.slot_grid import SlotGridSpec

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    n, skip, act, pe = 1000, (2,), "SoftplusQuad", sc.pe_scales(6, 0.0, 5.0)
    gspec = SlotGridSpec(num_levels=6, min_res=16, max_res=512, rows_per_level=4096,
                         layout="cell", feats=2, table_dtype="bf16")

    def chain(d_in, d_out, with_skip=True):
        dims = [(d_in, LIVE), (LIVE, LIVE), (LIVE + (d_in if with_skip else 0), LIVE),
                (LIVE, d_out)] if with_skip else [(d_in, LIVE), (LIVE, LIVE), (LIVE, d_out)]
        return random_chain(g, dims, dev)

    x = torch.rand(n, 39, generator=g, device=dev) * 2 - 1
    x5 = torch.rand(n, 15, generator=g, device=dev) * 2 - 1
    pos = torch.rand(n, 3, generator=g, device=dev) * 2.2 - 1.1
    tx = torch.randn(2, n, 39, generator=g, device=dev)
    gy65 = torch.randn(n, 65, generator=g, device=dev)
    gy17 = torch.randn(n, 17, generator=g, device=dev).to(torch.bfloat16)
    gty = torch.randn(2, n, 17, generator=g, device=dev).to(torch.bfloat16)
    gy33 = torch.randn(n, 33, generator=g, device=dev).to(torch.bfloat16)
    ga = torch.randn(n, 15, generator=g, device=dev)
    gsdf = torch.randn(n, generator=g, device=dev)
    ggeo = (0.1 * torch.randn(n, 256, generator=g, device=dev)).to(torch.bfloat16)
    g3 = torch.randn(n, 3, generator=g, device=dev)
    # name: (input width, output width, skip chain, run(ws, bs, skip) -> (per-row outputs,
    # [(gW list, gb list) or None], [other summed outputs]))
    def run_k1(ws, bs):
        y = fm.fused_chain(x, ws, bs, skip=skip, activation=act)
        gx, gws, gbs = fm._launch_bwd(x, gy65, ws, bs, skip, act, 100.0)
        return (y, gx), (gws, gbs)

    def rows_first(k):  # a backward's k per-row outputs, then its (gW list, gb list)
        return lambda o: (tuple(o[:k]), tuple(o[k:]))

    # name: (input width, output width, run(ws, bs) -> (per-row outputs, (gW list, gb list)))
    runs = {
        "K1": (39, 65, run_k1),
        "K1t": (39, 17, lambda ws, bs: rows_first(2)(fm._launch_tangent_bwd(
            x, tx, gy17, gty, ws, bs, skip, act, 100.0, None))),
        "K4": (39, 257, lambda ws, bs: rows_first(1)(sc._launch_bwd(
            pos, ws, bs, skip, act, 100.0, pe, gsdf, ggeo, g3))),
        "K4j": (39, 257, lambda ws, bs: rows_first(1)(sc._launch_jvp_bwd(
            pos, ws, bs, skip, act, 100.0, pe, gsdf, ggeo, g3))),
        "K5": (15, 33, lambda ws, bs: rows_first(1)(sc._launch_adj_bwd(
            x5, ws, bs, skip, act, 100.0, 1, gy33, ga))),
    }
    for name, (d_in, d_out, run) in runs.items():
        ws, bs = chain(d_in, d_out)
        ref_rows, ref_grads = run(ws, bs)
        for h in widths:
            for high in (False, True):
                what = f"{name} H={h} live units {'last' if high else 'first'}"
                wp, bp = pad_chain(ws, bs, skip, h, high)
                rows, grads = run(wp, bp)
                torch.cuda.synchronize()
                for i, (a, b) in enumerate(zip(rows, ref_rows)):
                    if not torch.equal(a, b):
                        fail(f"{what}: per-row output {i} differs from the 512-wide kernel's "
                             f"(rel_l2 {rel_l2(a.float(), b.float()):.3e})")
                gw, gb = unpad_grads(*grads, skip, h, high)
                _compare_grads(f"{what} vs 512 wide", ("gW", "gb"), (gw, gb), ref_grads,
                               tol=1e-5)
                print(f"  {what}: per-row outputs equal to the 512-wide kernel's, bit for bit")
    # the adjoint and tangent forwards, their outputs bit for bit
    tx3 = torch.randn(3, n, 39, generator=g, device=dev)
    kw4 = dict(SDF_KW, skip=skip)
    fwd_runs = {
        "K4 fwd": (39, 257, lambda ws, bs: sc.fused_sdf_chain(pos, ws, bs, **kw4)),
        "K4j fwd": (39, 257, lambda ws, bs: sc.fused_sdf_chain(pos, ws, bs, mode="jvp", **kw4)),
        "K5 fwd": (15, 33, lambda ws, bs: sc.fused_chain_adjoint(x5, ws, bs, skip=skip,
                                                                 channel=1)),
        "K1t fwd (3 tangents, channel 0)": (39, 17, lambda ws, bs: fm.fused_chain(
            x, ws, bs, skip=skip, activation=act, tangents=tx3, tangent_out_channel=0)),
        "K1t fwd (2 tangents, the full ty)": (39, 17, lambda ws, bs: fm.fused_chain(
            x, ws, bs, skip=skip, activation=act, tangents=tx)),
    }
    for name, (d_in, d_out, run) in fwd_runs.items():
        ws, bs = chain(d_in, d_out)
        with torch.no_grad():
            ref = run(ws, bs)
            for h in widths:
                for high in (False, True):
                    what = f"{name} H={h} live units {'last' if high else 'first'}"
                    out = run(*pad_chain(ws, bs, skip, h, high))
                    torch.cuda.synchronize()
                    for i, (a, b) in enumerate(zip(out, ref)):
                        if not torch.equal(a, b):
                            fail(f"{what}: output {i} differs from the 512-wide kernel's "
                                 f"(rel_l2 {rel_l2(a.float(), b.float()):.3e})")
                    print(f"  {what}: outputs equal to the 512-wide kernel's, bit for bit")
    # the slot kernels on the chain d_in -> 512 -> 512 -> 257, both tables: K2's and K3's
    # forwards, K2's backward (merged, split) on its own forward's residuals, K3's on the
    # plain forward's padded to the width (the live ones in place, z = -1 and s = 0 dead)
    for gs in (gspec, f32_spec()):
        tbl = slot_inputs(g, dev, gs)[0]
        ws, bs = chain(slot_d_in(gs), 257, with_skip=False)
        mk = (torch.arange(gs.out_dim, device=dev) < 3 * gs.feats).float()
        k = gs.num_levels
        fargs = (gs, k, 1.0, pe, act, 100.0, mk)
        cfwd = (gs, 1.0, pe, act, 100.0, mk)

        def slot_runs(wl, bl, zs, ss):
            """(per-row outputs, [(name, d_table, gW list, gb list)]) of the slot kernels on
            the chain (wl, bl), K3's backward on the residuals zs, ss (and adj)."""
            sdf, _, _, vzs, _, _, _ = sf._launch(pos, tbl, wl, bl, *fargs, False, resid=True)
            k3 = sf._launch(pos, tbl, wl, bl, *fargs, True)[:3]
            vm = sf._launch_value_bwd(pos, tbl, wl, bl, *fargs, vzs, gsdf)
            vs = sf._value_split_card(pos, tbl, wl, bl, *fargs, vzs, gsdf)
            cm = sf._launch_chain_bwd(pos, tbl, wl, bl, *cfwd, zs, ss, adj, gsdf, ggeo, g3)
            cs = sf._chain_split_card(pos, tbl, wl, bl, *cfwd, zs, ss, adj, gsdf, ggeo, g3)
            rows = (sdf, *k3, vm[0], vs[0], cm[0], cs[0])
            return rows, [(nm, o[1], o[2], o[3]) for nm, o in
                          (("K2 merged", vm), ("K2 split", vs), ("K3 merged", cm),
                           ("K3 split", cs))]

        zs, ss, adj, _ = sf._chain_fwd_plain(pos, tbl, ws, bs, *cfwd)[1]
        ref_rows, ref_grads = slot_runs(ws, bs, zs, ss)
        for h in widths:
            for high in (False, True):
                what = (f"{slot_tag('K2', gs)}/{slot_tag('K3', gs)} H={h} live units "
                        f"{'last' if high else 'first'}")
                o = h - LIVE if high else 0
                wp, bp = pad_chain(ws, bs, (), h, high)
                zp = torch.full((zs.shape[0], n, h), -1.0, device=dev).to(torch.bfloat16)
                sp = torch.zeros((ss.shape[0], n, h), device=dev).to(torch.bfloat16)
                zp[:, :, o:o + LIVE], sp[:, :, o:o + LIVE] = zs, ss
                rows, grads = slot_runs(wp, bp, zp, sp)
                torch.cuda.synchronize()
                for i, (a, b) in enumerate(zip(rows, ref_rows)):
                    if not torch.equal(a, b):
                        fail(f"{what}: per-row output {i} (sdf, K3's sdf, geo, grad, then d pos "
                             "of K2 merged, split, K3 merged, split) differs from the 512-wide "
                             f"kernels' (rel_l2 {rel_l2(a.float(), b.float()):.3e})")
                for (kind, dt, gw, gb), (_, dt_r, gw_r, gb_r) in zip(grads, ref_grads):
                    gw, gb = unpad_grads(gw, gb, (), h, high)
                    _compare_grads(f"{what} {kind} vs 512 wide", ("d_table", "gW", "gb"),
                                   (dt, gw, gb), (dt_r, gw_r, gb_r), tol=1e-5)
                print(f"  {what}: sdf, K3's outputs and every d pos equal to the 512-wide "
                      "kernels', bit for bit")


# grid_raw_tpu's slot grid without its position encoding: the SDF head takes
# [xyz, 6 levels x F = 2] into 128 -> 128 -> 257 SoftplusQuad
NOPE_DIMS = [(15, 128), (128, 128), (128, 257)]
# the same head on the vertex layout's table: [xyz, 6 levels x F = 16]
VERTEX_DIMS = [(99, 128), (128, 128), (128, 257)]


def _lookup_library(table, idx, w, dw, feats):
    """One PyTorch composition computing K6's function (bf16 table): the
    table cast to bf16, a gather of each sample's entry per level, and an
    einsum with the bf16 trilerp weights (and their derivatives)."""
    n, k = idx.shape
    tb = table.to(torch.bfloat16).reshape(-1, 8 * feats)
    T = tb[idx].reshape(n, k, feats, 8)
    enc = torch.einsum("nkfp,nkp->nkf", T, w.to(torch.bfloat16).reshape(n, k, 8))
    if dw is None:
        return enc
    return enc, torch.einsum("nkfp,ntkp->ntkf", T, dw.to(torch.bfloat16).reshape(n, 3, k, 8))


def _vertex_library(table, idx, w, dw):
    """One PyTorch composition computing K6v's function in f32: a gather of
    the 8 corner rows of each sample per level, their parity diagonal
    (lanes f*8 + p of corner p's row), and an einsum with the trilerp
    weights (and their derivatives)."""
    n, k = idx.shape[0], idx.shape[1] // 8
    rows = table[idx].reshape(n, k, 8, 16, 8)  # [n, k, corner p, f, lane parity q]
    T = torch.diagonal(rows, dim1=2, dim2=4)  # [n, k, f, p]
    enc = torch.einsum("nkfp,nkp->nkf", T, w.reshape(n, k, 8))
    if dw is None:
        return enc
    return enc, torch.einsum("nkfp,ntkp->ntkf", T, dw.reshape(n, 3, k, 8))


def lookup_fns(gspec):
    """K6's (or K6v's, for the vertex layout) forward and backward wrappers,
    their plain versions, a PyTorch composition of the forward and the
    rel-L2 limit of a check: (fwd, plain fwd, bwd, plain bwd, library,
    tol), each taking (table, idx, w, dw[, genc, gtenc]). The bf16 table
    rounds at the same points on both sides and sums in other orders
    (1e-2); an f32 table is exact f32 on both (1e-4)."""
    from multimodalstudio_tpu_torch.ops.kernels import slot_grid as sg

    feats, bf16 = gspec.feats, gspec.table_dtype == "bf16"
    if gspec.layout == "vertex":
        return (lambda *a: sg._lookup(*a, feats, bf16, True), sg.slot_lookup_vertex_plain,
                sg._launch_vertex_bwd, sg.slot_lookup_vertex_bwd_plain, _vertex_library, 1e-4)
    return (lambda *a: sg._lookup(*a, feats, bf16),
            lambda *a: sg.slot_lookup_plain(*a, feats=feats, bf16=bf16),
            lambda *a: sg._launch_bwd(*a, feats, bf16),
            lambda *a: sg.slot_lookup_bwd_plain(*a, feats=feats, bf16=bf16),
            lambda *a: _lookup_library(*a, feats), 1e-2 if bf16 else 1e-4)


def lookup_kernels(gspec):
    """The forward's and the backward's kernel names of K6 (K6v), as a
    profile shows them."""
    if gspec.layout == "vertex":
        return ("slot_vertex_fwd_kernel",), ("slot_vertex_bwd_kernel",)
    return ("slot_lookup_fwd_kernel",), ("slot_lookup_bwd_kernel",)


def lookup_tag(gspec):
    """A lookup kernel's label: K6, K6 with an f32 table, or K6v."""
    if gspec.layout == "vertex":
        return "K6v"
    return "K6" + (" f32" if gspec.table_dtype == "f32" else "")


def lookup_inputs(gen, dev, gspec, n, k):
    from multimodalstudio_tpu_torch.ops.kernels.slot_grid import CLIP_HI, slot_geometry

    table = slot_inputs(gen, dev, gspec)[0]
    x = (torch.rand(n, 3, generator=gen, device=dev) * 1.1 - 0.05).clamp(0.0, CLIP_HI)
    return (table, *slot_geometry(x, gspec, k))


def lookup_flops(n, k, feats, tangents):
    """f32 multiply-adds of K6's forward: 8 corners per feature, per output."""
    return 2.0 * 8 * n * k * feats * (4 if tangents else 1)


def lookup_bytes(gspec, table, idx, *tensors):
    """Bytes K6 (K6v) must move: the table rows of the levels idx reads, a
    4-byte index per sample and level (per corner in the vertex layout), and
    the given tensors."""
    k = idx.shape[1] // (8 if gspec.layout == "vertex" else 1)
    rows = gspec.total_rows if k >= gspec.num_levels else int(gspec.level_offsets[k])
    return rows * table.shape[1] * table.element_size() + 4 * idx.numel() + nbytes(*tensors)


def lookup_bwd_bytes(gspec, table, idx, w, dw, genc, gtenc, outs):
    """Bytes K6's (K6v's) backward must move on these cotangents: genc
    (gtenc) and the outputs `outs` whole; idx (4 bytes an index), w (and dw) only of the
    (sample, level)s whose cotangents are not all zero, and the table rows
    only of the levels some of them reach (elsewhere the outputs are zero
    whatever those hold: the coarse-to-fine mask)."""
    n, feats = genc.shape[0], gspec.feats
    live = (genc.reshape(n, -1, feats) != 0).any(-1)  # [n, k]
    if gtenc is not None:
        live |= (gtenc.reshape(n, 3, -1, feats) != 0).any(-1).any(1)
    offs = [int(o) for o in gspec.level_offsets] + [gspec.total_rows]
    table_rows = sum(offs[l + 1] - offs[l] for l, a in enumerate(live.any(0).tolist()) if a)
    # a 4-byte index, as lookup_bytes counts it
    per_level = (4 * idx.numel() + nbytes(w, *([dw] if dw is not None else []))) / live.numel()
    return (table_rows * table.shape[1] * table.element_size() + per_level * int(live.sum())
            + nbytes(genc, *outs, *([gtenc] if gtenc is not None else [])))


def _moved(ts, gen):
    """Each tensor (or None) moved by 1e-6, relative, with gen's draws."""
    return [t * (1 + 1e-6 * torch.randn(t.shape, generator=gen, device=t.device))
            if t is not None else None for t in ts]


def check_slot_grid_lookup(gen, dev, gspec, timed=True):
    """K6's (K6v's) forward at one training microbatch's render samples
    (N=163840, 6 levels, with tangents) and the sampler's queries (4
    levels, without), and timed over one 1024-ray eval chunk: 4 sampler
    queries (32768 + 3 x 8192 samples, 4 levels) and 65536 render samples
    with tangents. Prints the plain version against itself with w and dw
    moved by 1e-6 (relative; a generator of its own) beside each check."""
    fwd, plain, _, _, library, tol = lookup_fns(gspec)
    tag, feats = lookup_tag(gspec), gspec.feats
    err = 0.0
    for n, k, tang in ((163840, gspec.num_levels, True), (163840, 4, False)):
        table, idx, w, dw = lookup_inputs(gen, dev, gspec, n, k)
        dw = dw if tang else None
        out = fwd(table, idx, w, dw)
        ref = plain(table, idx, w, dw)
        names = ("enc", "tenc") if tang else ("enc",)
        what = f"{tag} fwd N={n} {k} levels"
        err = max(err, _compare_outputs(what, names, out if tang else (out,),
                                        ref if tang else (ref,), tol=tol))
        spread = plain(table, idx, *_moved((w, dw), torch.Generator(device=dev).manual_seed(SEED)))
        _compare_outputs(what + ", plain vs plain with w, dw moved by 1e-6", names,
                         spread if tang else (spread,), ref if tang else (ref,), tol=float("inf"))
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0, err=err,
               peak=H100_F32_FLOPS, kernel_ms=0.0, ops=0)
    if not timed:
        return tot
    names = lookup_kernels(gspec)[0]
    for n, k, tang, count in ((32768, 4, False, 1), (8192, 4, False, 3),
                              (65536, gspec.num_levels, True, 1)):
        table, idx, w, dw = lookup_inputs(gen, dev, gspec, n, k)
        dw = dw if tang else None
        out = fwd(table, idx, w, dw)
        tot["ms"] += count * time_ms(lambda: fwd(table, idx, w, dw))
        tot["kernel_ms"] += count * kernel_alone_ms(lambda: fwd(table, idx, w, dw), names)
        tot["ops"] = max(tot["ops"], device_ops(lambda: fwd(table, idx, w, dw)))
        tot["plain_ms"] += count * time_ms(lambda: plain(table, idx, w, dw))
        tot["library_ms"] += count * time_ms(lambda: library(table, idx, w, dw))
        tot["flops"] += count * lookup_flops(n, k, feats, tang)
        tot["bytes"] += count * lookup_bytes(gspec, table, idx, w, *([dw] if tang else []), out)
    return tot


def check_slot_grid_lookup_bwd(gen, dev, gspec, timed=True):
    """K6's (K6v's) backward at one training microbatch: the render samples
    (N=163840, 6 levels, with tangents) and the curvature taps (N=81920, 6
    levels, without), cotangents on the first 3 levels only (3 active). The
    tolerance's scale: the plain backward against itself with w and dw
    moved by 1e-6 (relative), since d_table is summed by atomics."""
    _, _, bwd, plain, library, tol = lookup_fns(gspec)
    tag, feats, k = lookup_tag(gspec), gspec.feats, gspec.num_levels
    mask = (torch.arange(k * feats, device=dev) < 3 * feats).float()
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0, err=0.0,
               peak=H100_F32_FLOPS, kernel_ms=0.0, ops=0)
    for n, tang in ((163840, True), (81920, False)):
        table, idx, w, dw = lookup_inputs(gen, dev, gspec, n, k)
        dw = dw if tang else None
        genc = torch.randn(n, k * feats, generator=gen, device=dev) * mask
        gtenc = (torch.randn(n, 3, k * feats, generator=gen, device=dev) * mask).reshape(n, -1)
        gtenc = gtenc if tang else None
        args = (table, idx, w, dw, genc, gtenc)
        got = bwd(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        names = ("d_table", "d_w", "d_dw") if tang else ("d_table", "d_w")
        what = f"{tag} bwd N={n}" + (" with tangents" if tang else "")
        tot["err"] = max(tot["err"], _compare_grads(what, names, got, want, tol=tol))
        _compare_grads(what + ", plain vs plain with w, dw moved by 1e-6", names, want,
                       plain(table, idx, *_moved((w, dw), gen), genc, gtenc), tol=float("inf"))
        if not timed:
            continue
        tl = table.clone().requires_grad_(True)
        wl = w.clone().requires_grad_(True)
        dwl = dw.clone().requires_grad_(True) if tang else None
        outs = library(tl, idx, wl, dwl)
        leaves = [tl, wl] + ([dwl] if tang else [])
        cot_dt = torch.bfloat16 if gspec.table_dtype == "bf16" else torch.float32
        cot = [genc.to(cot_dt).reshape(n, k, feats)]
        if tang:
            outs = list(outs)
            cot.append(gtenc.to(cot_dt).reshape(n, 3, k, feats))
        else:
            outs = [outs]

        def lib():
            return torch.autograd.grad(outs, leaves, cot, retain_graph=True)

        tot["ms"] += time_ms(lambda: bwd(*args))
        tot["kernel_ms"] += kernel_alone_ms(lambda: bwd(*args), lookup_kernels(gspec)[1])
        tot["ops"] = max(tot["ops"], device_ops(lambda: bwd(*args)))
        tot["plain_ms"] += time_ms(lambda: plain(*args))
        tot["library_ms"] += time_ms(lib)
        del outs
        # d_w and d_dw: a product per corner, feature and output; u: 2 (4) per lane
        tot["flops"] += lookup_flops(n, k, feats, tang) * 2
        tot["bytes"] += lookup_bwd_bytes(gspec, table, idx, w, dw, genc, gtenc,
                                         got[:3 if tang else 2])
    return tot


def unit_rays(gen, dev, rays=512, per_ray=320):
    """Grid positions [rays * per_ray, 3] in [0, 1] ordered as the sampler
    emits them: each ray a line through a uniform point of the unit cube in
    a uniform direction, its samples uniform along the chord the cube cuts
    from it and sorted along it (512 x 320: one training microbatch's render
    samples), all drawn from gen."""
    from multimodalstudio_tpu_torch.ops.kernels.slot_grid import CLIP_HI

    o = torch.rand(rays, 1, 3, generator=gen, device=dev)
    d = F.normalize(torch.randn(rays, 1, 3, generator=gen, device=dev), dim=-1)
    d = torch.where(d.abs() < 1e-6, torch.full_like(d, 1e-6), d)
    lo, hi = -o / d, (1.0 - o) / d
    t0 = torch.minimum(lo, hi).amax(-1, keepdim=True)
    t1 = torch.maximum(lo, hi).amin(-1, keepdim=True)
    t = torch.sort(torch.rand(rays, per_ray, 1, generator=gen, device=dev), dim=1).values
    return (o + (t0 + (t1 - t0) * t) * d).reshape(-1, 3).clamp(0.0, CLIP_HI)


def ray_taps(x, per_ray=320, stride=4, delta=1.0 / 16):
    """The curvature taps of ray-ordered samples x as training takes them
    (curvature_tap_stride 4, curvature_taps 2): every stride-th sample of
    each ray +- a tetrahedron direction k_j (j = its index % 4) of length
    delta / sqrt 3, delta that of a first active level of resolution 16 in
    grid units; [rays * per_ray / stride * 2, 3], in ray order."""
    from multimodalstudio_tpu_torch.models.model import TETRAHEDRON
    from multimodalstudio_tpu_torch.ops.kernels.slot_grid import CLIP_HI

    pos = x.reshape(-1, per_ray, 3)[:, ::stride]
    k = torch.tensor(TETRAHEDRON, device=x.device)
    kj = k[torch.arange(pos.shape[1], device=x.device) % 4] * (delta / 3**0.5)
    return torch.stack([pos + kj, pos - kj], dim=-2).reshape(-1, 3).clamp(0.0, CLIP_HI)


def check_lookup_ray_order(gen, dev, gspec):
    """K6v (or K6, for the cell layout) at positions ordered as the sampler
    emits them (unit_rays, a table and cotangents all drawn from gen), where
    consecutive samples share most corner rows (entries): the forward at one
    training microbatch's render samples (N = 163840, 6 levels, with
    tangents) and curvature taps (N = 81920, ray_taps, without), and the
    backward at both with cotangents on level 0 only (one active level, as
    training runs it) and on the first 3 (the uniform check's case), each
    within its plain version's limit (lookup_fns: 1e-4 exact f32, 1e-2 a
    bf16 table). Returns the forward's, the 1-level and the 3-level
    backward's wrapper and kernel-alone ms, each summed over the two calls,
    with their bounds' flops and bytes."""
    from multimodalstudio_tpu_torch.ops.kernels.slot_grid import slot_geometry

    fwd, plain, bwd, plain_bwd, _, tol = lookup_fns(gspec)
    fwd_names, bwd_names = lookup_kernels(gspec)
    tag, k, feats = lookup_tag(gspec), gspec.num_levels, gspec.feats
    table = slot_inputs(gen, dev, gspec)[0]
    x = unit_rays(gen, dev)
    calls = []
    for pos, tang in ((x, True), (ray_taps(x), False)):
        idx, w, dw = slot_geometry(pos, gspec, k)
        calls.append((pos.shape[0], idx, w, dw if tang else None))
    parts = [dict(ms=0.0, kernel_ms=0.0, flops=0.0, bytes=0.0, err=0.0) for _ in range(3)]
    for n, idx, w, dw in calls:
        tang = dw is not None
        names = ("enc", "tenc") if tang else ("enc",)
        out, ref = fwd(table, idx, w, dw), plain(table, idx, w, dw)
        what = f"{tag} fwd N={n}, ray-ordered" + (" with tangents" if tang else "")
        r = parts[0]
        r["err"] = max(r["err"], _compare_outputs(what, names, out if tang else (out,),
                                                  ref if tang else (ref,), tol=tol))
        r["ms"] += time_ms(lambda: fwd(table, idx, w, dw))
        r["kernel_ms"] += kernel_alone_ms(lambda: fwd(table, idx, w, dw), fwd_names)
        r["flops"] += lookup_flops(n, k, feats, tang)
        r["bytes"] += lookup_bytes(gspec, table, idx, w, *([dw] if tang else []), out)
        for r, active in zip(parts[1:], (1, 3)):
            mask = (torch.arange(k * feats, device=dev) < active * feats).float()
            genc = torch.randn(n, k * feats, generator=gen, device=dev) * mask
            gtenc = (torch.randn(n, 3, k * feats, generator=gen, device=dev) * mask).reshape(n, -1)
            args = (table, idx, w, dw, genc, gtenc if tang else None)
            got, want = bwd(*args), plain_bwd(*args)
            torch.cuda.synchronize()
            grads = ("d_table", "d_w", "d_dw") if tang else ("d_table", "d_w")
            r["err"] = max(r["err"], _compare_grads(
                f"{tag} bwd N={n}, ray-ordered, {active} active level(s)", grads, got, want,
                tol=tol))
            r["ms"] += time_ms(lambda: bwd(*args))
            r["kernel_ms"] += kernel_alone_ms(lambda: bwd(*args), bwd_names)
            r["flops"] += lookup_flops(n, k, feats, tang) * 2
            r["bytes"] += lookup_bwd_bytes(gspec, table, idx, w, dw, genc, args[5],
                                           got[:3 if tang else 2])
    for what, r in zip(("fwd (render samples and taps)", "bwd, 1 active level",
                        "bwd, 3 active levels"), parts):
        b_ms, b_by = bound(r["flops"], r["bytes"], H100_F32_FLOPS)
        print(f"  {tag} {what}, ray-ordered, per 512-ray training microbatch: {r['ms']:.3f} ms, "
              f"kernel alone {r['kernel_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    return tuple(parts)


def check_lookup_edges(gen, dev, gspec) -> None:
    """K6 (K6v) off the main path's shapes: a ragged N = 1000 on 3 levels
    without tangents and on all with, forward and backward; for the cell
    layout also F = 4 and F = 8 (no registered method's grid) at a ragged
    N = 999 on 3 levels with tangents, drawn from a generator of their own
    so that later phases draw what they drew before."""
    import dataclasses

    cases = [(gspec, gen, 1000, 3, False), (gspec, gen, 1000, gspec.num_levels, True)]
    if gspec.layout == "cell":
        own = torch.Generator(device=dev).manual_seed(SEED + 7)
        cases += [(dataclasses.replace(gspec, feats=f), own, 999, 3, True) for f in (4, 8)]
    for spec, g, n, k, tang in cases:
        check_lookup_call(g, dev, spec, n, k, tang)


def check_lookup_call(gen, dev, gspec, n, k, tang) -> None:
    """K6 (K6v) forward and backward on one draw of n samples at k levels,
    with tangents or without, against their plain versions."""
    fwd, plain, bwd, plain_bwd, _, tol = lookup_fns(gspec)
    tag, feats = f"{lookup_tag(gspec)} F={gspec.feats}", gspec.feats
    table, idx, w, dw = lookup_inputs(gen, dev, gspec, n, k)
    dw = dw if tang else None
    names = ("enc", "tenc") if tang else ("enc",)
    out, ref = fwd(table, idx, w, dw), plain(table, idx, w, dw)
    _compare_outputs(f"{tag} fwd {k} levels N={n}", names, out if tang else (out,),
                     ref if tang else (ref,), tol=tol)
    genc = torch.randn(n, k * feats, generator=gen, device=dev)
    gtenc = torch.randn(n, 3 * k * feats, generator=gen, device=dev) if tang else None
    _compare_grads(f"{tag} bwd {k} levels N={n}", ("d_table", "d_w", "d_dw")[:len(names) + 1],
                   bwd(table, idx, w, dw, genc, gtenc), plain_bwd(table, idx, w, dw, genc, gtenc),
                   tol=tol)


def check_chain_adjoint(gen, dev, dims=NOPE_DIMS, what="K5"):
    """K5's forward at one 1024-ray eval chunk's render samples (N=65536)
    and one training microbatch's (N=163840), on the SoftplusQuad chain
    `dims` (NOPE_DIMS, or VERTEX_DIMS for the vertex table's 99 inputs)."""
    from multimodalstudio_tpu_torch.ops.kernels.sdf_chain import (
        fused_chain_adjoint,
        fused_chain_adjoint_plain,
    )

    ws, bs = random_chain(gen, dims, dev)
    err = 0.0
    for n in (163840, 65536):
        x = torch.rand(n, dims[0][0], generator=gen, device=dev) * 2 - 1
        with torch.no_grad():
            out = fused_chain_adjoint(x, ws, bs)
            ref = fused_chain_adjoint_plain(x, ws, bs)
        torch.cuda.synchronize()
        err = max(err, _compare_outputs(f"{what} fwd N={n}", ("y", "adj"), out, ref))
    library, _ = adjoint_library(x, ws, bs)
    with torch.no_grad():
        ms = time_ms(lambda: fused_chain_adjoint(x, ws, bs))
        plain_ms = time_ms(lambda: fused_chain_adjoint_plain(x, ws, bs))
    kernel_ms, ops = fwd_parts(f"{what} fwd N={n} (wrapper {ms:.3f} ms)",
                               lambda: fused_chain_adjoint(x, ws, bs), ADJ_FWD_KERNELS)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=time_ms(library),
                flops=sdf_flops(n, dims), bytes=nbytes(x, ws, bs, out), err=err,
                kernel_ms=kernel_ms, ops=ops)


def check_chain_adjoint_bwd(gen, dev, dims=NOPE_DIMS, what="K5", conditioned=False):
    """K5's backward at one training microbatch's render samples: N=163840,
    cotangents on y (bf16) and adj, on the chain `dims`. With `conditioned`
    its limits follow the plain version's spread (_plain_conditioning, a
    generator of its own), else the plain spread is printed beside 1e-2.
    Then the backward in its parts (stacked_backward_parts)."""
    from multimodalstudio_tpu_torch.ops.kernels.sdf_chain import (
        _launch_adj_bwd,
        _launch_adj_fwd,
        adj_bwd_card,
        fused_chain_adjoint_bwd_plain,
    )

    n, d_in = 163840, dims[0][0]
    ws, bs = random_chain(gen, dims, dev)
    x = torch.rand(n, d_in, generator=gen, device=dev) * 2 - 1
    gy = (0.1 * torch.randn(n, dims[-1][1], generator=gen, device=dev)).to(torch.bfloat16)
    ga = torch.randn(n, d_in, generator=gen, device=dev)
    kargs = (x, ws, bs, (), "SoftplusQuad", 100.0, 0, gy, ga)
    got = _launch_adj_bwd(*kargs)
    want = fused_chain_adjoint_bwd_plain(x, ws, bs, gy, ga)
    torch.cuda.synchronize()
    if conditioned:
        limits = _plain_conditioning(f"{what} bwd N={n}", CHAIN_GRADS,
                                     fused_chain_adjoint_bwd_plain, lambda b: (x, ws, b, gy, ga),
                                     bs, {}, torch.Generator(device=dev).manual_seed(SEED), dev,
                                     want)
        err = _compare_grads(f"{what} bwd N={n}", CHAIN_GRADS, got, want, tol=limits)
    else:
        err = _compare_grads(f"{what} bwd N={n}", CHAIN_GRADS, got, want)
        moved = [b * (1 + 1e-6 * torch.randn(b.shape, generator=gen, device=dev)) for b in bs]
        _compare_grads(f"{what} bwd N={n}, plain vs plain with biases moved by 1e-6", CHAIN_GRADS,
                       want, fused_chain_adjoint_bwd_plain(x, ws, moved, gy, ga), tol=float("inf"))
    fn, leaves = adjoint_library(x, ws, bs, create_graph=True)
    outs = fn()

    def library():
        return torch.autograd.grad(outs, leaves, (gy, ga.to(torch.bfloat16)), retain_graph=True)

    packed = _launch_adj_fwd(*kargs[:7])[2]
    res = dict(ms=time_ms(lambda: _launch_adj_bwd(*kargs, packed)),
               standalone_ms=time_ms(lambda: _launch_adj_bwd(*kargs)),
               plain_ms=time_ms(lambda: fused_chain_adjoint_bwd_plain(x, ws, bs, gy, ga)),
               library_ms=time_ms(library), flops=sdf_flops(n, dims, backward=True),
               bytes=nbytes(x, ws, bs, gy, ga, got[0], got[1], got[2]), err=err)
    res["wgrad"] = stacked_backward_parts(
        f"{what} bwd N={n}", lambda count: adj_bwd_card(*kargs, count=count),
        lambda: _launch_adj_bwd(*kargs, packed), adjoint_rows(n, len(dims)),
        old_atomics(n, dims, ()), res, gate=False)
    return res


def check_nope_edges(gen, dev, gspec) -> None:
    """K6 and K5 off the main path's shapes: K6's check_lookup_edges; K5
    with a skip layer at channel 1, a ragged N."""
    from multimodalstudio_tpu_torch.ops.kernels.sdf_chain import (
        _launch_adj_bwd,
        fused_chain_adjoint,
        fused_chain_adjoint_bwd_plain,
        fused_chain_adjoint_plain,
    )

    check_lookup_edges(gen, dev, gspec)
    n = 1000
    dims = [(15, 128), (128, 128), (143, 128), (128, 33)]
    ws, bs = random_chain(gen, dims, dev)
    kw = dict(skip=(2,), activation="SoftplusQuad", beta=100.0, channel=1)
    x = torch.rand(n, 15, generator=gen, device=dev) * 2 - 1
    with torch.no_grad():
        _compare_outputs(f"K5 skip=(2,) channel 1 N={n}", ("y", "adj"),
                         fused_chain_adjoint(x, ws, bs, **kw), fused_chain_adjoint_plain(x, ws, bs, **kw))
    gy = torch.randn(n, 33, generator=gen, device=dev).to(torch.bfloat16)
    ga = torch.randn(n, 15, generator=gen, device=dev)
    _compare_grads(f"K5 bwd skip=(2,) channel 1 N={n}", CHAIN_GRADS,
                   _launch_adj_bwd(x, ws, bs, (2,), "SoftplusQuad", 100.0, 1, gy, ga),
                   fused_chain_adjoint_bwd_plain(x, ws, bs, gy, ga, **kw))


def check_sdf_head(gen, dev, dims=VERTEX_DIMS):
    """K1 on the SDF head of grid_raw_tpu without PE (SoftplusQuad, no
    skip): the forward at the sampler's queries, timed over one 1024-ray
    eval chunk (32768 + 3 x 8192), and at a training microbatch's curvature
    taps (N=81920); the backward at the taps, whose cotangent is the sdf
    column's alone (sdf_only keeps that column), its limits following the
    plain version's spread (_plain_conditioning, a generator of its own).
    Returns the forward's and the backward's timings."""
    from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import (
        _launch_bwd,
        fused_chain,
        fused_chain_bwd_plain,
        fused_chain_plain,
    )

    kw = dict(activation="SoftplusQuad", beta=100.0)
    ws, bs = random_chain(gen, dims, dev)
    wb, bb = bf16_leaves(ws, bs, False)
    fwd = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0, err=0.0)
    for n, count in ((32768, 1), (8192, 3), (81920, 0)):
        x = torch.rand(n, dims[0][0], generator=gen, device=dev) * 2 - 1
        with torch.no_grad():
            y = fused_chain(x, ws, bs, **kw)
            ref = fused_chain_plain(x, ws, bs, **kw)
            torch.cuda.synchronize()
            fwd["err"] = max(fwd["err"], _compare_outputs(f"K1 SDF head fwd N={n}", ("y",), (y,),
                                                          (ref,)))
            if not count:
                continue
            xb = x.to(torch.bfloat16)
            fwd["ms"] += count * time_ms(lambda: fused_chain(x, ws, bs, **kw))
            fwd["plain_ms"] += count * time_ms(lambda: fused_chain_plain(x, ws, bs, **kw))
            fwd["library_ms"] += count * time_ms(lambda: linear_chain(xb, wb, bb))
        kernel_ms, ops = k1_forward_parts(f"K1 SDF head fwd N={n}", x, ws, bs, kw)
        fwd["kernel_ms"] = fwd.get("kernel_ms", 0.0) + count * kernel_ms
        fwd["ops"] = max(fwd.get("ops", 0), ops)
        fwd["flops"] += count * chain_flops(n, dims)
        fwd["bytes"] += count * nbytes(x, ws, bs, y)
    n = 81920
    x = torch.rand(n, dims[0][0], generator=gen, device=dev) * 2 - 1
    gy = torch.zeros(n, dims[-1][1], device=dev)
    gy[:, 0] = torch.randn(n, generator=gen, device=dev)
    gy = gy.to(torch.bfloat16)
    args = (x, gy, ws, bs, (), kw["activation"], kw["beta"])
    out = _launch_bwd(*args)
    ref = fused_chain_bwd_plain(x, gy, ws, bs, **kw)
    torch.cuda.synchronize()
    limits = _plain_conditioning(f"K1 bwd SDF head N={n}", CHAIN_GRADS, fused_chain_bwd_plain,
                                 lambda b: (x, gy, ws, b), bs, kw,
                                 torch.Generator(device=dev).manual_seed(SEED), dev, ref)
    err = _compare_grads(f"K1 bwd SDF head N={n}", CHAIN_GRADS, out, ref, tol=limits)
    wl, bl = bf16_leaves(ws, bs, True)
    xl = x.to(torch.bfloat16).requires_grad_(True)
    h = linear_chain(xl, wl, bl)

    def library():
        return torch.autograd.grad(h, [xl, *wl, *bl], gy, retain_graph=True)

    # the last layer's cotangent is the sdf column's only
    live = dims[:-1] + [(dims[-1][0], 1)]
    ms, alone_ms = k1_backward_ms(x, gy, ws, bs, (), kw["activation"], kw["beta"])
    bwd = dict(ms=ms, standalone_ms=alone_ms,
               plain_ms=time_ms(lambda: fused_chain_bwd_plain(x, gy, ws, bs, **kw)),
               library_ms=time_ms(library),
               flops=chain_flops(n, dims[:-1]) + 2 * chain_flops(n, live),
               bytes=k1_bwd_bytes(x, gy, ws, bs, out), err=err)
    bwd["err"] = max(err, k1_backward_parts(f"SDF head N={n}", x, gy, ws, bs, kw, bwd))
    bwd.pop("parts")
    for what, r in (("fwd", fwd), ("bwd", bwd)):
        alone = f" ({r['standalone_ms']:.3f} ms packing its own)" if "standalone_ms" in r else ""
        print(f"  K1 SDF head {what}: wrapper {r['ms']:.3f} ms{alone}, kernel alone "
              f"{r['kernel_ms']:.3f} ms, at most {r['ops']} device ops per call, library "
              f"{r['library_ms']:.3f} ms")
    return fwd, bwd


def print_timing(what, r, peak=H100_BF16_FLOPS):
    """One check's kernel, plain and library ms beside its bound."""
    b_ms, b_by = bound(r["flops"], r["bytes"], peak)
    print(f"  {what}: {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library "
          f"{r['library_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by}), max_abs_err {r['err']:.3e}")


# ------------------------------------------------- K2s, K3s and the table scatter

# the split's table scatter kernel, by its name in a profile
SCATTER_KERNELS = ("slot_table_scatter_kernel",)

# the per-sample passes' outputs held against their plain versions: the pass's d pos
# and table cotangent (their gW and gb, from chain_wgrad over the pass's stacks, are
# held in the whole split backward against the merged one's)
SPLIT_OUTPUTS = {"value": ("d_pos", "d_comp"), "chain": ("d_pos", "d_comp")}


def _split_forward(what, fwd, launch_args, plain):
    """The training forward with the split's x0 residual against the plain
    forward's (x0's padding columns exactly zero); plain(*fwd) returns (sdf,
    its residuals with x0 last). Returns (the kernel's residuals (zs, ss,
    adj, x0), the plain residuals, the largest abs error)."""
    from multimodalstudio_tpu_torch.ops.kernels.slot_fused import _launch

    out_k = _launch(*launch_args, resid=True, x0=True)
    outs_p, res_p = plain(*fwd)
    if not launch_args[-1]:  # K2's forward (no gradient)
        fwd_ms = time_ms(lambda: _launch(*launch_args, resid=True, x0=True))
        slot_value_parts(f"{what} training fwd with x0 (wrapper {fwd_ms:.3f} ms)",
                         lambda: _launch(*launch_args, resid=True, x0=True))
    x0, x0_p = out_k[6], res_p[-1]
    err = _compare_outputs(f"{what} training fwd with x0", ("sdf", "zs", "x0"),
                           (out_k[0], out_k[3], x0[:, : x0_p.shape[1]]), (outs_p, res_p[0], x0_p))
    if float(x0[:, x0_p.shape[1]:].float().abs().max()) != 0.0:
        fail(f"{what} training forward wrote nonzero x0 padding")
    return out_k[3:], res_p, err


def _split_checks(what, names, sample, sample_plain, scatter_args, merged, whole):
    """Hold one split backward on the card: the per-sample kernel against its
    plain version (each reading its own forward's residuals) at rel-L2 1e-2,
    the scatter kernel against its plain version on the kernel's cotangent
    at 1e-2, and the whole split backward (per-sample kernel, scatter kernel,
    products) against the merged backward kernel at the JAX test's limits
    (tests/test_slot_fused.py:189-193: d_table and d_pos 1e-5, gW and gb
    2e-2). Returns the timings and errors."""
    from multimodalstudio_tpu_torch.ops.kernels.slot_fused import (
        _launch_table_scatter,
        slot_table_scatter_plain,
    )

    got = sample()
    want = sample_plain()
    torch.cuda.synchronize()
    err = _compare_outputs(f"{what} per-sample pass", names, got, want)
    pos, gspec = scatter_args
    d_comp = got[1]
    table_k = _launch_table_scatter(pos, d_comp, gspec, 1.0)
    table_p = slot_table_scatter_plain(pos, d_comp, gspec, radius=1.0)
    scatter_err = _compare_outputs(f"{what} table scatter", ("d_table",), (table_k,), (table_p,))
    split, ref = whole(), merged()
    torch.cuda.synchronize()
    _compare_grads(f"{what} whole split backward vs the merged backward kernel", SLOT_GRADS[:2],
                   split[:2], ref[:2], tol=1e-5)
    _compare_grads(f"{what} whole split backward vs the merged backward kernel", SLOT_GRADS[2:],
                   split[2:], ref[2:], tol=2e-2)
    # the merged backward adds each nonzero table cotangent value with one f32 atomic
    return dict(got=got, err=err, scatter_err=scatter_err, dcomp_values=d_comp.numel(),
                atomics=int((d_comp != 0).sum()), dcomp_bytes=nbytes(d_comp),
                ms=time_ms(sample), plain_ms=time_ms(sample_plain),
                scatter_ms=time_ms(lambda: _launch_table_scatter(pos, d_comp, gspec, 1.0)),
                scatter_kernel_ms=kernel_alone_ms(
                    lambda: _launch_table_scatter(pos, d_comp, gspec, 1.0), SCATTER_KERNELS),
                scatter_ops=device_ops(lambda: _launch_table_scatter(pos, d_comp, gspec, 1.0)),
                scatter_plain_ms=time_ms(lambda: slot_table_scatter_plain(pos, d_comp, gspec,
                                                                          radius=1.0)),
                whole_ms=time_ms(whole), merged_ms=time_ms(merged))


def check_slot_value_split(gen, dev, gspec):
    """K2s and the table scatter at one training microbatch's curvature taps
    (N=81920, all 6 levels, 3 active), with the products' and the whole
    split backward's times beside the merged K2 backward's (for an f32
    table: K2f's, the cotangent f32)."""
    from multimodalstudio_tpu_torch.ops.kernels.slot_fused import (
        _launch_value_bwd,
        _launch_value_bwd_sample,
        _value_fwd_plain,
        _value_split_card,
        pe_scales,
        slot_sdf_value_bwd_sample_plain,
        value_bwd_card,
    )

    table, ws, bs = slot_inputs(gen, dev, gspec)
    n, k = 81920, gspec.num_levels
    pos = torch.rand(n, 3, generator=gen, device=dev) * 2.2 - 1.1
    mask = (torch.arange(gspec.out_dim, device=dev) < 3 * gspec.feats).float()
    pe = pe_scales(6, 0.0, 5.0)
    fwd = (pos, table, ws, bs, gspec, k, 1.0, pe, "SoftplusQuad", 100.0, mask)
    (zs, _, _, _), (zs_p, _), fwd_err = _split_forward(
        slot_tag("K2", gspec), fwd, (*fwd, False),
        lambda *a: (lambda s, z, x: (s, (z, x)))(*_value_fwd_plain(*a)))
    gsdf = torch.randn(n, generator=gen, device=dev)
    skw = dict(radius=1.0, pe=pe, activation="SoftplusQuad", beta=100.0, mask=mask, num_levels=k)
    r = _split_checks(
        f"{slot_tag('K2', gspec)}s N={n}", SPLIT_OUTPUTS["value"],
        lambda: _launch_value_bwd_sample(*fwd, zs, gsdf),
        lambda: slot_sdf_value_bwd_sample_plain(pos, table, ws, gspec, zs_p, gsdf, **skw),
        (pos, gspec), lambda: _launch_value_bwd(*fwd, zs, gsdf),
        lambda: _value_split_card(*fwd, zs, gsdf))
    bw = value_bwd_card(*fwd, zs, gsdf, split=True)[0]
    r["products_ms"] = time_ms(bw.wgrad)
    r["kernel_ms"] = time_ms(lambda: (bw.tile(), bw.wgrad()))
    r["ops"] = device_ops(lambda: _value_split_card(*fwd, zs, gsdf))
    print(f"  {slot_tag('K2', gspec)}s N={n} per-sample pass: kernel alone (pass and chain_wgrad) "
          f"{r['kernel_ms']:.3f} ms, chain_wgrad {r['products_ms']:.3f} ms, {r['ops']} device "
          "ops per whole split backward")
    # the sweep's gh products (the last layer's sdf column only), no gW
    r["flops"] = chain_flops(n, [(slot_d_in(gspec), 128), (128, 128), (128, 1)])
    r["bytes"] = nbytes(pos, table, mask, ws, bs, zs, gsdf, *r["got"][:2])
    r["scatter_bytes"] = nbytes(pos, r["got"][1]) + 4 * gspec.total_rows * 128
    r["fwd_err"] = fwd_err
    return r


def check_slot_chain_split(gen, dev, gspec):
    """K3s and the table scatter at one training microbatch's render samples
    (N=163840, all 6 levels, 3 active, cotangents on sdf, geo and grad),
    with the products' (chain_wgrad over the pass's stacks) and the whole
    split backward's times beside the merged K3 backward's (for an f32
    table: K3f's, the cotangent f32); then the whole split backward at
    positions ordered as the sampler emits them (ray_positions) against the
    merged backward kernel there."""
    from multimodalstudio_tpu_torch.ops.kernels.slot_fused import (
        _chain_fwd_plain,
        _chain_split_card,
        _launch,
        _launch_chain_bwd,
        _launch_chain_bwd_sample,
        pe_scales,
        slot_sdf_chain_bwd_sample_plain,
    )

    table, ws, bs = slot_inputs(gen, dev, gspec)
    n = 163840
    pos = torch.rand(n, 3, generator=gen, device=dev) * 2.2 - 1.1
    mask = (torch.arange(gspec.out_dim, device=dev) < 3 * gspec.feats).float()
    pe = pe_scales(6, 0.0, 5.0)
    fwd = (pos, table, ws, bs, gspec, 1.0, pe, "SoftplusQuad", 100.0, mask)
    launch_args = (*fwd[:5], gspec.num_levels, *fwd[5:], True)
    (zs, ss, adj, x0), (zs_p, ss_p, adj_p, _), fwd_err = _split_forward(
        slot_tag("K3", gspec), fwd, launch_args,
        lambda *a: (lambda o, res: (o[0], res))(*_chain_fwd_plain(*a)))
    gsdf = torch.randn(n, generator=gen, device=dev)
    ggeo = (0.1 * torch.randn(n, 256, generator=gen, device=dev)).to(torch.bfloat16)
    g3 = torch.randn(n, 3, generator=gen, device=dev)
    skw = dict(radius=1.0, pe=pe, activation="SoftplusQuad", beta=100.0, mask=mask)
    cot = (gsdf, ggeo, g3)
    what = f"{slot_tag('K3', gspec)}s N={n}"
    r = _split_checks(
        what, SPLIT_OUTPUTS["chain"],
        lambda: _launch_chain_bwd_sample(*fwd, zs, ss, adj, *cot),
        lambda: slot_sdf_chain_bwd_sample_plain(pos, table, ws, gspec, zs_p, ss_p, adj_p, *cot,
                                                **skw),
        (pos, gspec), lambda: _launch_chain_bwd(*fwd, zs, ss, adj, *cot),
        lambda: _chain_split_card(*fwd, zs, ss, adj, *cot))
    parts = k3_parts(f"{what} per-sample pass", (*fwd, zs, ss, adj, *cot), gspec, True)
    parts.pop("bw")
    r["products_ms"] = parts["wgrad_ms"]
    r["kernel_ms"], r["ops"] = parts["kernel_ms"], parts["ops"]
    # the ray-ordered draw, against the merged backward kernel on it
    rpos = ray_positions(n, dev, SEED + 2)
    rfwd = (rpos, *fwd[1:])
    r_out = _launch(*rfwd[:5], gspec.num_levels, *rfwd[5:], True, resid=True, x0=True)
    rres = (*r_out[3:6], *cot)
    split, merged = _chain_split_card(*rfwd, *rres), _launch_chain_bwd(*rfwd, *rres)
    torch.cuda.synchronize()
    _compare_grads(f"{what}, ray-ordered: whole split backward vs the merged backward kernel",
                   SLOT_GRADS[:2], split[:2], merged[:2], tol=1e-5)
    _compare_grads(f"{what}, ray-ordered: whole split backward vs the merged backward kernel",
                   SLOT_GRADS[2:], split[2:], merged[2:], tol=2e-2)
    print(f"  {what}, ray-ordered: per-sample pass "
          f"{time_ms(lambda: _launch_chain_bwd_sample(*rfwd, *rres)):.3f} ms, whole split "
          f"{time_ms(lambda: _chain_split_card(*rfwd, *rres)):.3f} ms")
    hidden = [(slot_d_in(gspec), 128), (128, 128)]
    # the ga-forward chain's products through the hidden layers and the
    # sweep's gh products of every layer; no gW
    r["flops"] = chain_flops(n, hidden) + chain_flops(n, hidden + [(128, 257)])
    r["bytes"] = nbytes(pos, table, mask, ws, bs, zs, ss, adj, *cot, *r["got"][:2])
    r["scatter_bytes"] = nbytes(pos, r["got"][1]) + 4 * gspec.total_rows * 128
    r["fwd_err"] = fwd_err
    return r


def split_results(value, chain, f32=False):
    """The kernel-table entries of K2s, K3s and the scatter (its two launches
    of a training microbatch summed), with `f32` those of the f32 table's
    kernels; prints the split against the merged backward."""
    sfx = "f" if f32 else ""
    for name, r in ((f"K2{sfx}", value), (f"K3{sfx}", chain)):
        products = "products (chain_wgrad, inside the per-sample kernel's call)"
        print(f"  {name} split backward per microbatch: per-sample kernel {r['ms']:.3f} ms, "
              f"scatter {r['scatter_ms']:.3f} ms, {products} {r['products_ms']:.3f} ms, whole "
              f"{r['whole_ms']:.3f} ms; merged backward kernel {r['merged_ms']:.3f} ms; table "
              f"cotangent {r['dcomp_bytes'] / 1e6:.1f} MB, {r['atomics']} nonzero values")
    entries = {}
    sfx = "_f32" if f32 else ""
    for name, r in ((f"fused_slot_sdf_value{sfx}_bwd_sample", value),
                    (f"fused_slot_sdf_chain{sfx}_bwd_sample", chain)):
        entries[name] = dict(ms=r["ms"], plain_ms=r["plain_ms"], flops=r["flops"],
                             bytes=r["bytes"], err=r["err"],
                             **({"kernel_ms": r["kernel_ms"], "ops": r["ops"]} if "ops" in r
                                else {}))
    entries[f"slot_table_scatter{sfx}"] = dict(
        ms=value["scatter_ms"] + chain["scatter_ms"],
        kernel_ms=value["scatter_kernel_ms"] + chain["scatter_kernel_ms"],
        ops=max(value["scatter_ops"], chain["scatter_ops"]),
        plain_ms=value["scatter_plain_ms"] + chain["scatter_plain_ms"],
        # one f32 add per cotangent value, outside the tensor cores
        flops=float(value["dcomp_values"] + chain["dcomp_values"]),
        bytes=value["scatter_bytes"] + chain["scatter_bytes"],
        err=max(value["scatter_err"], chain["scatter_err"]), peak=H100_F32_FLOPS)
    return entries


def check_scatter_ray_order(gen, dev, gspec):
    """The split's table scatter (gspec's table) at positions ordered as the
    sampler emits them, on the per-sample passes' own table cotangents with
    one active level, as training runs it: K3s's at one training
    microbatch's render samples (unit_rays in the box of radius 1, N =
    163840, cotangents on sdf, geo and grad) and K2s's at their curvature
    taps (ray_taps, N = 81920). Each scatter within 1e-2 of its plain
    version, each whole split backward within the JAX test's limits of the
    merged backward kernel on the same input (d_table and d_pos 1e-5, gW
    and gb 2e-2). Returns the scatter's wrapper and kernel-alone ms, summed
    over the two calls, with its bound's flops and bytes."""
    from multimodalstudio_tpu_torch.ops.kernels.slot_fused import (
        _chain_split_card,
        _launch,
        _launch_chain_bwd,
        _launch_chain_bwd_sample,
        _launch_table_scatter,
        _launch_value_bwd,
        _launch_value_bwd_sample,
        _value_split_card,
        pe_scales,
        slot_table_scatter_plain,
    )

    table, ws, bs = slot_inputs(gen, dev, gspec)
    x = unit_rays(gen, dev)
    pe = pe_scales(6, 0.0, 5.0)
    mask = (torch.arange(gspec.out_dim, device=dev) < gspec.feats).float()
    k3, k2 = slot_tag("K3", gspec), slot_tag("K2", gspec)
    pos = x * 2 - 1
    n = pos.shape[0]
    fwd = (pos, table, ws, bs, gspec, 1.0, pe, "SoftplusQuad", 100.0, mask)
    out = _launch(*fwd[:5], gspec.num_levels, *fwd[5:], True, resid=True, x0=True)
    res = (*out[3:6], torch.randn(n, generator=gen, device=dev),
           (0.1 * torch.randn(n, 256, generator=gen, device=dev)).to(torch.bfloat16),
           torch.randn(n, 3, generator=gen, device=dev))
    tpos = ray_taps(x) * 2 - 1
    nt = tpos.shape[0]
    vfwd = (tpos, table, ws, bs, gspec, gspec.num_levels, 1.0, pe, "SoftplusQuad", 100.0, mask)
    vres = (_launch(*vfwd, False, resid=True, x0=True)[3],
            torch.randn(nt, generator=gen, device=dev))
    calls = ((f"{k3}s N={n}", pos, _launch_chain_bwd_sample(*fwd, *res)[1],
              lambda: _chain_split_card(*fwd, *res), lambda: _launch_chain_bwd(*fwd, *res)),
             (f"{k2}s N={nt}", tpos, _launch_value_bwd_sample(*vfwd, *vres)[1],
              lambda: _value_split_card(*vfwd, *vres), lambda: _launch_value_bwd(*vfwd, *vres)))
    r = dict(ms=0.0, kernel_ms=0.0, flops=0.0, bytes=0.0, err=0.0)
    for what, p, d_comp, whole, merged in calls:
        what += ", ray-ordered, one active level"
        got = _launch_table_scatter(p, d_comp, gspec, 1.0)
        want = slot_table_scatter_plain(p, d_comp, gspec, radius=1.0)
        split, ref = whole(), merged()
        torch.cuda.synchronize()
        r["err"] = max(r["err"], _compare_outputs(f"{what}: table scatter", ("d_table",), (got,),
                                                  (want,)))
        _compare_grads(f"{what}: whole split backward vs the merged backward kernel",
                       SLOT_GRADS[:2], split[:2], ref[:2], tol=1e-5)
        _compare_grads(f"{what}: whole split backward vs the merged backward kernel",
                       SLOT_GRADS[2:], split[2:], ref[2:], tol=2e-2)
        live = float((d_comp != 0).any(-1).float().mean())
        print(f"  {what}: {100 * live:.1f}% of (sample, level) chunks not all zero")
        r["ms"] += time_ms(lambda: _launch_table_scatter(p, d_comp, gspec, 1.0))
        r["kernel_ms"] += kernel_alone_ms(lambda: _launch_table_scatter(p, d_comp, gspec, 1.0),
                                          SCATTER_KERNELS)
        # the positions and the cotangent read once, the table gradient written once; an f32
        # add per cotangent value
        r["flops"] += float(d_comp.numel())
        r["bytes"] += nbytes(p, d_comp) + 4 * gspec.total_rows * 128
    b_ms, b_by = bound(r["flops"], r["bytes"], H100_F32_FLOPS)
    print(f"  {k3}s and {k2}s table scatter, ray-ordered, one active level, per 512-ray training "
          f"microbatch: {r['ms']:.3f} ms, kernel alone {r['kernel_ms']:.3f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")
    return r


# --------------------------------------------------- depth past the registered methods


def check_depth_edges(gen, dev) -> None:
    """Chains and grids deeper than any registered method's: a 10-layer chain
    through K1 (ReLU, a skip), K4 and K5 (SoftplusQuad, a skip), forward and
    backward, and the slot kernels (K2, K3 forward, merged and split
    backward, scatter) on 9 and 16 grid levels and with a 10-layer chain,
    each against its plain version at N=1000 (the 10-layer slot chain at
    N=40000). The 10-layer K4 and K5 backwards take their limit from the
    plain version's spread."""
    from multimodalstudio_tpu_torch.ops.kernels.fused_mlp import (
        _launch_bwd as k1_bwd,
        fused_chain,
        fused_chain_bwd_plain,
        fused_chain_plain,
    )
    from multimodalstudio_tpu_torch.ops.kernels.sdf_chain import (
        _launch_adj_bwd,
        _launch_bwd,
        fused_chain_adjoint,
        fused_chain_adjoint_bwd_plain,
        fused_chain_adjoint_plain,
        fused_sdf_chain,
        fused_sdf_chain_bwd_plain,
        fused_sdf_chain_plain,
        pe_scales,
    )
    from multimodalstudio_tpu_torch.ops.kernels.slot_grid import SlotGridSpec

    n = 1000

    def deep(d_in, d_out):  # 10 layers, the skip at layer 4
        return ([(d_in, 128)] + [(128, 128)] * 3 + [(128 + d_in, 128)] + [(128, 128)] * 4
                + [(128, d_out)])

    spread_gen = torch.Generator(device=dev).manual_seed(SEED)
    dims = deep(39, 17)
    ws, bs = random_chain(gen, dims, dev)
    x = torch.rand(n, 39, generator=gen, device=dev) * 2 - 1
    kw = dict(skip=(4,), activation="ReLU")
    _compare_outputs(f"K1 10 layers ReLU skip=(4,) N={n}", ("y",), (fused_chain(x, ws, bs, **kw),),
                     (fused_chain_plain(x, ws, bs, **kw),))
    gy = torch.randn(n, 17, generator=gen, device=dev).to(torch.bfloat16)
    _compare_grads(f"K1 bwd 10 layers ReLU skip=(4,) N={n}", CHAIN_GRADS,
                   k1_bwd(x, gy, ws, bs, (4,), "ReLU", 100.0),
                   fused_chain_bwd_plain(x, gy, ws, bs, **kw))
    dims = deep(39, 33)
    ws, bs = random_chain(gen, dims, dev)
    pos = torch.rand(n, 3, generator=gen, device=dev) * 2.2 - 1.1
    kw = dict(SDF_KW, skip=(4,))
    with torch.no_grad():
        _compare_outputs(f"K4 10 layers N={n}", ("sdf", "geo", "grad"),
                         fused_sdf_chain(pos, ws, bs, **kw), fused_sdf_chain_plain(pos, ws, bs, **kw))
    gsdf = torch.randn(n, generator=gen, device=dev)
    ggeo = torch.randn(n, 32, generator=gen, device=dev).to(torch.bfloat16)
    g3 = torch.randn(n, 3, generator=gen, device=dev)
    want = fused_sdf_chain_bwd_plain(pos, ws, bs, gsdf, ggeo, g3, **kw)
    limits = _plain_conditioning(f"K4 bwd 10 layers N={n}", CHAIN_GRADS, fused_sdf_chain_bwd_plain,
                                 lambda b: (pos, ws, b, gsdf, ggeo, g3), bs, kw, spread_gen, dev,
                                 want)
    _compare_grads(f"K4 bwd 10 layers N={n}", CHAIN_GRADS,
                   _launch_bwd(pos, ws, bs, (4,), "SoftplusQuad", 100.0, pe_scales(6, 0.0, 5.0),
                               gsdf, ggeo, g3), want, tol=limits)
    dims = deep(15, 33)
    ws, bs = random_chain(gen, dims, dev)
    x = torch.rand(n, 15, generator=gen, device=dev) * 2 - 1
    kw = dict(skip=(4,), activation="SoftplusQuad", beta=100.0)
    with torch.no_grad():
        _compare_outputs(f"K5 10 layers N={n}", ("y", "adj"), fused_chain_adjoint(x, ws, bs, **kw),
                         fused_chain_adjoint_plain(x, ws, bs, **kw))
    gy = torch.randn(n, 33, generator=gen, device=dev).to(torch.bfloat16)
    ga = torch.randn(n, 15, generator=gen, device=dev)
    want = fused_chain_adjoint_bwd_plain(x, ws, bs, gy, ga, **kw)
    limits = _plain_conditioning(f"K5 bwd 10 layers N={n}", CHAIN_GRADS,
                                 fused_chain_adjoint_bwd_plain, lambda b: (x, ws, b, gy, ga), bs,
                                 kw, spread_gen, dev, want)
    _compare_grads(f"K5 bwd 10 layers N={n}", CHAIN_GRADS,
                   _launch_adj_bwd(x, ws, bs, (4,), "SoftplusQuad", 100.0, 0, gy, ga), want,
                   tol=limits)
    for levels in (9, 16):
        gspec = SlotGridSpec(num_levels=levels, min_res=16, max_res=512, rows_per_level=4096,
                             layout="cell", feats=2, table_dtype="bf16")
        check_slot_levels(gen, dev, gspec, n)
    # 10 layers: the residual stacks leave shared memory for per-CTA scratch, and at
    # 40,000 samples each CTA of the persistent grid walks several tiles
    gspec = SlotGridSpec(num_levels=6, min_res=16, max_res=512, rows_per_level=4096,
                         layout="cell", feats=2, table_dtype="bf16")
    check_slot_levels(gen, dev, gspec, 40000, hidden_layers=8)


def check_slot_levels(gen, dev, gspec, n, hidden_layers=1) -> None:
    """K2, K3, their merged and split backwards and the scatter on one grid
    (the chain 3 + 36 + 2 levels -> 128 (-> 128) x hidden_layers -> 257,
    all levels active but the last), each against its plain version. A
    deeper chain's backward checks take their limits from the plain
    version's spread, its biases moved by 1e-6 through the forward."""
    from multimodalstudio_tpu_torch.ops.kernels.slot_fused import (
        _chain_fwd_plain,
        _launch,
        _launch_chain_bwd,
        _launch_chain_bwd_sample,
        _launch_table_scatter,
        _launch_value_bwd,
        _launch_value_bwd_sample,
        _value_fwd_plain,
        pe_scales,
        slot_sdf_chain_bwd_plain,
        slot_sdf_chain_bwd_sample_plain,
        slot_sdf_value_bwd_plain,
        slot_sdf_value_bwd_sample_plain,
        slot_table_scatter_plain,
    )
    from multimodalstudio_tpu_torch.ops.kernels.slot_grid import make_table_init

    k, feats = gspec.num_levels, gspec.feats
    what = f"{k} levels {hidden_layers + 2} layers N={n}"
    table = make_table_init(gspec)(gen) * 1e4
    ws, bs = random_chain(gen, [(39 + k * feats, 128)] + [(128, 128)] * hidden_layers
                          + [(128, 257)], dev)
    pos = torch.rand(n, 3, generator=gen, device=dev) * 2.2 - 1.1
    mask = (torch.arange(k * feats, device=dev) < (k - 1) * feats).float()
    pe = pe_scales(6, 0.0, 5.0)
    skw = dict(radius=1.0, pe=pe, activation="SoftplusQuad", beta=100.0, mask=mask)
    spread_gen = torch.Generator(device=dev).manual_seed(SEED)

    def check(name, names, got, plain):
        """The kernel's outputs against plain(bs), plain(b) running the plain
        forward with biases b and then the plain backward."""
        want = plain(bs)
        limits = 1e-2
        if hidden_layers > 1:
            limits = _plain_conditioning(name, names, plain, lambda b: (b,), bs, {}, spread_gen,
                                         dev, want)
        _compare_grads(name, names, got, want, tol=limits)

    fwd = (pos, table, ws, bs, gspec, k, 1.0, pe, "SoftplusQuad", 100.0, mask)
    sdf, _, _, zs, _, _, _ = _launch(*fwd, False, resid=True)
    sdf_p, zs_p, _ = _value_fwd_plain(*fwd)
    _compare_outputs(f"K2 training fwd {what}", ("sdf", "zs"), (sdf, zs), (sdf_p, zs_p))
    fwd_ms = time_ms(lambda: _launch(*fwd, False, resid=True))
    slot_value_parts(f"K2 training fwd {what} (wrapper {fwd_ms:.3f} ms)",
                     lambda: _launch(*fwd, False, resid=True))
    gsdf = torch.randn(n, generator=gen, device=dev)

    def value_zs(b):
        return _value_fwd_plain(pos, table, ws, b, gspec, k, 1.0, pe, "SoftplusQuad", 100.0,
                                mask)[1]

    check(f"K2 bwd {what}", SLOT_GRADS, _launch_value_bwd(*fwd, zs, gsdf),
          lambda b: slot_sdf_value_bwd_plain(pos, table, ws, b, gspec, value_zs(b), gsdf,
                                             **SLOT_KW, level_mask=mask))
    got = _launch_value_bwd_sample(*fwd, zs, gsdf)
    check(f"K2s {what}", SPLIT_OUTPUTS["value"], got,
          lambda b: slot_sdf_value_bwd_sample_plain(pos, table, ws, gspec, value_zs(b), gsdf,
                                                    num_levels=k, **skw))
    _compare_outputs(f"table scatter {what}", ("d_table",),
                     (_launch_table_scatter(pos, got[1], gspec, 1.0),),
                     (slot_table_scatter_plain(pos, got[1], gspec, radius=1.0),))
    cfwd = (pos, table, ws, bs, gspec, 1.0, pe, "SoftplusQuad", 100.0, mask)
    out_k = _launch(*fwd, True, resid=True)
    outs_p, (zs_p, ss_p, adj_p, _) = _chain_fwd_plain(*cfwd)
    _compare_outputs(f"K3 training fwd {what}", ("sdf", "geo", "grad", "zs", "ss", "adj"), out_k,
                     (*outs_p, zs_p, ss_p, adj_p))
    ggeo = (0.1 * torch.randn(n, 256, generator=gen, device=dev)).to(torch.bfloat16)
    g3 = torch.randn(n, 3, generator=gen, device=dev)
    cot = (gsdf, ggeo, g3)

    def chain_resid(b):
        return _chain_fwd_plain(pos, table, ws, b, gspec, 1.0, pe, "SoftplusQuad", 100.0,
                                mask)[1][:3]

    check(f"K3 bwd {what}", SLOT_GRADS, _launch_chain_bwd(*cfwd, *out_k[3:6], *cot),
          lambda b: slot_sdf_chain_bwd_plain(pos, table, ws, b, gspec, *chain_resid(b), *cot,
                                             **SLOT_KW, level_mask=mask))
    check(f"K3s {what}", SPLIT_OUTPUTS["chain"], _launch_chain_bwd_sample(*cfwd, *out_k[3:6], *cot),
          lambda b: slot_sdf_chain_bwd_sample_plain(pos, table, ws, gspec, *chain_resid(b), *cot,
                                                    **skw))


def skip_chain(d_in, skip_layer, n_layers):
    """A slot chain of n_layers (x0 -> 128 ... -> 257) whose layer
    skip_layer takes [128 | x0]."""
    return ([(d_in, 128)] + [(128 + d_in if l == skip_layer else 128, 128)
                             for l in range(1, n_layers - 1)] + [(128, 257)])


def check_skip_edges(gen, dev, gspecs) -> None:
    """The slot kernels with a skip connection, which no registered method's
    SDF has: for each table type of gspecs a 4-layer SoftplusQuad chain
    (x0 -> 128 -> 128 -> [128 | x0] -> 128 -> 257, the skip at layer 2) at a
    ragged N = 1000, then on the last gspec a 10-layer ReLU chain with the
    skip at layer 4 at N = 40,000, whose residual stacks leave shared
    memory for per-CTA scratch (ReLU: no act'' terms, so a fixed limit
    holds at that depth); 4 of 6 levels active. K2 and K3 forward (training
    mode), their merged backwards, K2s, K3s and the scatter against their
    plain versions at 1e-2, and each whole split backward against the
    merged backward kernel at the JAX test's limits (d_table and d_pos
    1e-5, gW and gb 2e-2)."""
    from multimodalstudio_tpu_torch.ops.kernels.slot_fused import (
        _chain_fwd_plain,
        _chain_split_card,
        _launch,
        _launch_chain_bwd,
        _launch_chain_bwd_sample,
        _launch_table_scatter,
        _launch_value_bwd,
        _launch_value_bwd_sample,
        _value_fwd_plain,
        _value_split_card,
        pe_scales,
        slot_sdf_chain_bwd_plain,
        slot_sdf_chain_bwd_sample_plain,
        slot_sdf_value_bwd_plain,
        slot_sdf_value_bwd_sample_plain,
        slot_table_scatter_plain,
    )
    from multimodalstudio_tpu_torch.ops.kernels.slot_grid import make_table_init

    pe = pe_scales(6, 0.0, 5.0)
    cases = ([(g, 1000, 2, 4, "SoftplusQuad") for g in gspecs]
             + [(gspecs[-1], 40000, 4, 10, "ReLU")])
    for gspec, n, skip_layer, n_layers, act in cases:
        skip = (skip_layer,)
        what = f"{n_layers} layers {act} skip={skip} {gspec.table_dtype} table N={n}"
        table = make_table_init(gspec)(gen) * 1e4
        ws, bs = random_chain(gen, skip_chain(slot_d_in(gspec), skip_layer, n_layers), dev)
        pos = torch.rand(n, 3, generator=gen, device=dev) * 2.2 - 1.1
        mask = (torch.arange(gspec.out_dim, device=dev) < 4 * gspec.feats).float()
        k = gspec.num_levels
        chain = (1.0, pe, act, 100.0, mask)
        kw = dict(SLOT_KW, activation=act, level_mask=mask, skip=skip)
        skw = dict(radius=1.0, pe=pe, activation=act, beta=100.0, mask=mask, skip=skip)
        fwd = (pos, table, ws, bs, gspec, k, *chain)
        sdf, _, _, zs, _, _, _ = _launch(*fwd, False, resid=True, x0=True, skip=skip)
        sdf_p, zs_p, _ = _value_fwd_plain(*fwd, skip)
        _compare_outputs(f"K2 training fwd {what}", ("sdf", "zs"), (sdf, zs), (sdf_p, zs_p))
        gsdf = torch.randn(n, generator=gen, device=dev)
        merged = _launch_value_bwd(*fwd, zs, gsdf, skip)
        _compare_grads(f"K2 bwd {what}", SLOT_GRADS, merged, slot_sdf_value_bwd_plain(
            pos, table, ws, bs, gspec, zs_p, gsdf, **kw))
        got = _launch_value_bwd_sample(*fwd, zs, gsdf, skip)
        _compare_outputs(f"K2s {what}", SPLIT_OUTPUTS["value"], got,
                         slot_sdf_value_bwd_sample_plain(pos, table, ws, gspec, zs_p, gsdf,
                                                         num_levels=k, **skw))
        _compare_outputs(f"table scatter {what}", ("d_table",),
                         (_launch_table_scatter(pos, got[1], gspec, 1.0),),
                         (slot_table_scatter_plain(pos, got[1], gspec, radius=1.0),))
        split = _value_split_card(*fwd, zs, gsdf, skip)
        _compare_grads(f"K2 whole split backward vs merged {what}", SLOT_GRADS[:2], split[:2],
                       merged[:2], tol=1e-5)
        _compare_grads(f"K2 whole split backward vs merged {what}", SLOT_GRADS[2:], split[2:],
                       merged[2:], tol=2e-2)
        cfwd = (pos, table, ws, bs, gspec, *chain)
        out_k = _launch(*fwd, True, resid=True, x0=True, skip=skip)
        outs_p, (zs_p, ss_p, adj_p, _) = _chain_fwd_plain(*cfwd, skip)
        _compare_outputs(f"K3 training fwd {what}", ("sdf", "geo", "grad", "zs", "ss", "adj"),
                         out_k[:6], (*outs_p, zs_p, ss_p, adj_p))
        cot = (gsdf, (0.1 * torch.randn(n, 256, generator=gen, device=dev)).to(torch.bfloat16),
               torch.randn(n, 3, generator=gen, device=dev))
        merged = _launch_chain_bwd(*cfwd, *out_k[3:6], *cot, skip)
        _compare_grads(f"K3 bwd {what}", SLOT_GRADS, merged, slot_sdf_chain_bwd_plain(
            pos, table, ws, bs, gspec, zs_p, ss_p, adj_p, *cot, **kw))
        got = _launch_chain_bwd_sample(*cfwd, *out_k[3:6], *cot, skip)
        _compare_outputs(f"K3s {what}", SPLIT_OUTPUTS["chain"], got,
                         slot_sdf_chain_bwd_sample_plain(pos, table, ws, gspec, zs_p, ss_p, adj_p,
                                                         *cot, **skw))
        split = _chain_split_card(*cfwd, *out_k[3:6], *cot, skip)
        _compare_grads(f"K3 whole split backward vs merged {what}", SLOT_GRADS[:2], split[:2],
                       merged[:2], tol=1e-5)
        _compare_grads(f"K3 whole split backward vs merged {what}", SLOT_GRADS[2:], split[2:],
                       merged[2:], tol=2e-2)


# the reference methods' labels (CONFIGS): float32 with TF32 off and no kernel, so a render
# chunk and a training microbatch must agree with the CPU's to float32 summation order
REFERENCE_LABELS = ("grid_raw", "mlp_raw", "grid", "grid_raw_grid_bg_unbalanced")

# VolSDF, the box collider (ModelSpec's default aabb, the +-1 cube) and random background
# colours, which take the background field's place (JAX tests "random" before a background
# field), so the label has none: its parameters would get no gradient
VOLSDF_BOX = {"model": {"surface": {"rendering": "volsdf"}, "collider_type": "box",
                        "background_color": "random", "use_background": False}}
VOLSDF_LABEL = "grid_raw_tpu with VolSDF, box collider, random background, radam"
# VOLSDF_LABEL's optimizer groups (load_config's overrides cannot reach into the pairs): the
# fields on RAdam at a constant learning rate, as under the 10 % warm-up the checked steps'
# rates (1e-7 to 7e-7), RAdam's unnormalised first 5 updates and its r of 0.026 at updates 6
# and 7 would move no weight-norm gain near 1 by an ulp; the camera poses on Adam. The label
# runs after phases A-D, so the earlier phases keep their order.
VOLSDF_OPTIMIZERS = {"fields": {"optimizer": "radam", "scheduler": None},
                     "camera_poses": {"optimizer": "adam"}}
# VOLSDF_LABEL's microbatch also runs through the plain versions on the card, and each gradient
# group of the kernels is held within 1e-1 of those. Against the CPU its slot-table group is held
# within VOLSDF_TABLE_TOL, twice the 1.442e-1 to 1.474e-1 that four runs read, every other group
# within the bf16 labels' limits. The box collider clips rays to the grid's own bounds, so the
# uniform samples of a ray that crosses the box face to face lie on the grid's cell planes, where
# the last bit of a position picks the cell its gradient goes to; card and CPU compute the rays'
# positions an ulp apart. Given the card's positions the CPU's table gradient equals the card's
# bit for bit (chip_probes/volsdf_table_replay.py, box_cell_planes.py; PERF.md §6)
VOLSDF_TABLE_TOL = 3e-1

PER_CHUNK = {  # kernel launches of one 1024-ray eval chunk (derived in PERF.md)
    # every K1 forward call launches the pack of its weights, then the chain,
    # and so does every K2 call (its chain cut to the sdf column) and every
    # call of K3, K4, K5, K1t and K4j (the tenth pack)
    # trunk, polarization head, background x3; sampler x4; render samples
    "grid_raw_tpu": {"fused_chain": 5, "fused_chain_pack": 10, "fused_slot_sdf_value": 4,
                     "fused_slot_sdf_chain": 1},
    # sampler x4 and the five chains above through K1; render samples through K4
    "mlp_raw_tpu": {"fused_chain": 9, "fused_chain_pack": 10, "fused_sdf_chain": 1},
    # sampler x4 through K6 (4 levels) and the K1 head, the five chains above
    # through K1; render samples through K6 with tangents and K5
    "grid_raw_tpu without PE": {"fused_chain": 9, "fused_chain_pack": 10, "slot_grid_lookup": 5,
                                "fused_chain_adjoint": 1},
    # as mlp_raw_tpu, the render samples through K1t (contraction) or K4j (jvp mode)
    "mlp_raw_tpu with contraction": {"fused_chain": 9, "fused_chain_pack": 10,
                                     "fused_chain_tangents": 1},
    "mlp_raw_tpu in jvp mode": {"fused_chain": 9, "fused_chain_pack": 10, "fused_sdf_chain_jvp": 1},
    # the split backward changes nothing a render runs
    "grid_raw_tpu with split backward": {"fused_chain": 5, "fused_chain_pack": 10,
                                         "fused_slot_sdf_value": 4, "fused_slot_sdf_chain": 1},
    # as grid_raw_tpu, through the f32 table's K2f and K3f
    "grid_raw_tpu with f32 table": {"fused_chain": 5, "fused_chain_pack": 10,
                                    "fused_slot_sdf_value_f32": 4, "fused_slot_sdf_chain_f32": 1},
    # as grid_raw_tpu without PE, the lookups through K6v
    "grid_raw_tpu without PE, vertex layout": {"fused_chain": 9, "fused_chain_pack": 10,
                                               "slot_grid_lookup_vertex": 5,
                                               "fused_chain_adjoint": 1},
    # the reference methods run no kernel: f32 unfused MLPs and the plain hash grid
    **{label: {} for label in REFERENCE_LABELS},
    # as grid_raw_tpu without the background's three K1 chains
    VOLSDF_LABEL: {"fused_chain": 2, "fused_chain_pack": 7, "fused_slot_sdf_value": 4,
                   "fused_slot_sdf_chain": 1},
}

NO_PE = {"model": {"surface": {"surface_field": {"use_position_encoding": False}}}}
CONTRACTION = {"model": {"surface": {"contraction_order": float("inf")}}}
# the grid of two committed grid_raw_tpu checkpoints (capacity_base6, rehearsal_grid_dense,
# config.yaml:64-72): 6 levels of 512 entries, F = 16, an f32 table
F32_TABLE = {"model": {"surface": {"surface_field": {"field": {"grid": {"encoding": {
    "rows_per_level": 512, "feats": 16, "table_dtype": "f32"}}}}}}}
# the vertex layout's grid of the quality harness (configs/methods.py:356-359): 6 levels of
# 2048 rows, F = 16, an f32 table; without the position encoding, as the fused slot kernels
# refuse the layout
VERTEX_TABLE = {"model": {"surface": {"surface_field": {
    "use_position_encoding": False,
    "field": {"grid": {"encoding": {"layout": "vertex", "feats": 16, "table_dtype": "f32",
                                    "rows_per_level": 2048}}}}}}}
CONFIGS = {  # label: (registered method, load_config overrides, environment of its phases)
    "grid_raw_tpu": ("grid_raw_tpu", None, {}),
    "mlp_raw_tpu": ("mlp_raw_tpu", None, {}),
    "grid_raw_tpu without PE": ("grid_raw_tpu", NO_PE, {}),
    "mlp_raw_tpu with contraction": ("mlp_raw_tpu", CONTRACTION, {}),
    "mlp_raw_tpu in jvp mode": ("mlp_raw_tpu", None, {"MMS_SDF_CHAIN_MODE": "jvp"}),
    "grid_raw_tpu with split backward": ("grid_raw_tpu", None, {"MMS_SLOT_BWD_SPLIT": "1"}),
    "grid_raw_tpu with f32 table": ("grid_raw_tpu", F32_TABLE, {}),
    "grid_raw_tpu with f32 table and split backward": ("grid_raw_tpu", F32_TABLE,
                                                       {"MMS_SLOT_BWD_SPLIT": "1"}),
    "grid_raw_tpu without PE, vertex layout": ("grid_raw_tpu", VERTEX_TABLE, {}),
    # the reference methods, through the committed YAMLs of the reference (16 hash-grid levels
    # of 2^19 entries to max_res 1024; the grid SDF MLP 3 x 256 with numerical taps, the mlp one
    # 8 x 256 through jacfwd) or the registry at the bench microbatch
    "grid_raw": ("confs/grid_raw.yaml", None, {}),
    "mlp_raw": ("confs/mlp_raw.yaml", None, {}),
    "grid": ("confs/grid.yaml", None, {}),
    "grid_raw_grid_bg_unbalanced": ("grid_raw_grid_bg_unbalanced",
                                    {"datamanager": {"microbatch_rays": 512}}, {}),
    VOLSDF_LABEL: ("grid_raw_tpu", VOLSDF_BOX, {}),
}
# The committed rehearsal runs whose checkpoints the card renders (phase A) are rehearsals.py's
# catalog; for each, the CONFIGS label whose PER_CHUNK launches one of its eval chunks makes.
REHEARSAL_LABELS = {"rehearsal_mlp_dense": "mlp_raw_tpu",
                    "rehearsal_grid_dense": "grid_raw_tpu with f32 table",
                    "rehearsal_grid_packed_confirm": "grid_raw_tpu"}


# labels whose render is another label's (the split backward changes nothing a render
# runs): their render phase is not repeated
SAME_RENDER = {"grid_raw_tpu with f32 table and split backward": "grid_raw_tpu with f32 table"}


def load(label):
    """The config of one label, five modalities, through load_config (of a
    YAML file where the label names one)."""
    import dataclasses

    from multimodalstudio_tpu_torch.configs.config import load_config
    from multimodalstudio_tpu_torch.configs.methods import FIVE_MODALITIES

    method, overrides, _ = CONFIGS[label]
    if method.endswith(".yaml"):
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), method)
        cfg = load_config(path, overrides=overrides)
    else:
        cfg = load_config(method=method, overrides=overrides)
    groups = VOLSDF_OPTIMIZERS if label == VOLSDF_LABEL else {}
    optimizers = tuple((g, dataclasses.replace(spec, **groups.get(g, {})))
                       for g, spec in cfg.optimizers)
    return dataclasses.replace(cfg, modalities=FIVE_MODALITIES, optimizers=optimizers)


def fixed_background_colours(*models):
    """The random background colours of `models` drawn from one seeded CPU generator by
    shape, so a card model and a CPU model composite the same colours (their own seeded
    generators differ by device)."""
    def colours(mod, like, generator):
        gen = torch.Generator().manual_seed(SEED + like.numel())
        return torch.rand(like.shape, generator=gen).to(like)

    for model in models:
        model.random_background_color = colours


def config_env(label):
    """The environment of one label's phases, restored afterwards."""
    return environment(CONFIGS[label][2])


@contextlib.contextmanager
def environment(env, cleared=()):
    """The variables of `env` set and every other one that starts with a prefix in `cleared`
    unset, all restored afterwards."""
    saved = {k: os.environ.get(k) for k in env}
    saved.update({k: v for k, v in os.environ.items() if k.startswith(tuple(cleared))})
    for k in saved:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_slice(dev, card, method):
    """Render one eval view of every modality through the port's
    RawEvaluator (Evaluator on demosaicked frames) and check outputs,
    launch counts and a CPU re-render. `method` is a label of CONFIGS."""
    import dataclasses

    import numpy as np

    from multimodalstudio_tpu_torch.cameras.camera_optimizer import init_camera_poses
    from multimodalstudio_tpu_torch.configs.methods import FIVE_MODALITIES
    from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset
    from multimodalstudio_tpu_torch.engine.evaluator import Evaluator, RawEvaluator
    from multimodalstudio_tpu_torch.engine.train import TrainState
    from multimodalstudio_tpu_torch.models.model import MMSModel
    from multimodalstudio_tpu_torch.ops.kernels import build

    cfg = load(method)
    raw = cfg.datamanager.raw
    evaluator_cls = RawEvaluator if raw else Evaluator
    dataset = make_synthetic_dataset(FIVE_MODALITIES, num_views=10, height=256, width=256,
                                     raw=raw, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = MMSModel(cfg.model, device=dev).init(gen)
    num_cameras = {m: dataset.data[m].cameras.camera_to_worlds.shape[0] for m in FIVE_MODALITIES}
    poses = init_camera_poses(cfg.datamanager.camera_optimizer, FIVE_MODALITIES, num_cameras,
                              device=dev)
    state = TrainState(camera_poses=poses, step=cfg.max_num_iterations)
    evaluator = evaluator_cls(cfg, model, dataset, dataset, device=dev)
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
    want = {name: PER_CHUNK[method].get(name, 0) * chunks for name in build.KERNELS}
    print(f"  launches {launches}, expected {want} for {chunks} chunks")
    if launches != want:
        fail("the render did not go through every kernel as often as expected")
    print(f"  rendered {n_rays} rays in {seconds:.3f} s: {n_rays / seconds:.1f} rays/s "
          f"(eval, {method}, 5 modalities, {card})")

    # one chunk again on the CPU through the plain versions
    cpu_model = MMSModel(cfg.model, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    if cfg.model.background_color == "random":
        fixed_background_colours(model, cpu_model)
    cpu_eval = evaluator_cls(cfg, cpu_model, dataset, dataset, device="cpu")
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
    # importance samples can move with bf16 noise between the two, so loose; the reference
    # methods run float32 on both sides with TF32 off
    tol = 1e-3 if method in REFERENCE_LABELS else 5e-2
    print(f"  chunk vs CPU plain: worst rel_l2 {worst:.3e} (tolerance {tol:g})")
    if not worst <= tol:
        fail(f"the card's render disagrees with the CPU plain render (rel_l2 > {tol:g})")
    if cfg.model.collider_type == "box":
        render_near_far(dev, cfg, model, dataset, state, evaluator_cls)
    profile_device(lambda: evaluator.render_view(state, dataset, "rgb", 0), "one rgb view",
                   1e3 * seconds / len(frames))
    return launches, n_rays / seconds


def render_near_far(dev, cfg, model, dataset, state, evaluator_cls, near_far=(0.05, 4.0)):
    """View 0 of rgb once more, the model's weights under the near_far collider: every
    output finite."""
    import dataclasses

    import numpy as np

    from multimodalstudio_tpu_torch.models.model import MMSModel

    nf = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, collider_type="near_far",
                                                            near_far=near_far))
    nf_model = MMSModel(nf.model, device=dev)
    nf_model.load_state_dict(model.state_dict())
    t0 = time.perf_counter()
    frames = evaluator_cls(nf, nf_model, dataset, dataset, device=dev).render_view(
        state, dataset, "rgb", 0)
    torch.cuda.synchronize()
    bad = [k for k, v in frames.items() if not np.all(np.isfinite(v))]
    print(f"  near_far collider {near_far}: rgb view 0 in {time.perf_counter() - t0:.2f} s, "
          f"outputs {sorted(frames)} " + ("finite" if not bad else f"non-finite {bad}"))
    if bad:
        fail(f"the near_far collider's render has non-finite {bad}")


# the device kernels of the hash grid's row gather (index_select's, which torch.gather's shares)
# and table scatter (index_add_'s), by their names in a profile
INDEX_KERNELS = ("_scatter_gather_elementwise_kernel", "indexFunc")


def profile_device(fn, label: str, ref_ms: float, top: int = 12, parts=None):
    """Device time by kernel over one call of fn (torch.profiler), and the
    share of its wall time the card was busy, under the profiler and
    against an unprofiled call's time `ref_ms`; returns the latter share,
    the busy ms and the device ops. Where index_add_ ran (a hash grid's
    backward), the device ms of the INDEX_KERNELS (its gather and scatter)
    are printed, and stored in `parts["index_ms"]` when given.

    Only the device activity is recorded, and its raw events are summed by
    kernel name in one pass (utils/profiler.py::device_op_stats), without
    building the profiler's Python event list."""
    from torch.profiler import ProfilerActivity, profile

    from multimodalstudio_tpu_torch.utils.profiler import device_op_stats

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    rows = [(op["self_ms"], op["count"], op["name"]) for op in device_op_stats(prof)
            if op["self_ms"] > 0]
    index_ms = 0.0
    if any("indexFunc" in r[2] for r in rows):
        index_ms = sum(r[0] for r in rows if any(k in r[2] for k in INDEX_KERNELS))
    busy_ms = sum(r[0] for r in rows)
    print(f"  profile of {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%; {100 * busy_ms / ref_ms:.1f}% of an unprofiled "
          f"call's {ref_ms:.2f} ms), {sum(r[1] for r in rows)} device ops (events collected in "
          f"{t1 - t0 - wall_ms / 1e3:.1f} s, summed in {time.perf_counter() - t1:.1f} s)")
    ranked = sorted(rows, reverse=True)
    # the top kernels, and below them K6v's (PERF.md follows all four of its instantiations)
    for ms, count, key in ranked[:top] + [r for r in ranked[top:] if "slot_vertex" in r[2]]:
        print(f"    {ms:9.3f} ms {count:6d}x {key[:90]}")
    if index_ms:
        print(f"  index_select's gather and index_add_'s scatter kernels: {index_ms:.2f} ms, "
              f"{100 * index_ms / busy_ms:.1f}% of the device busy time")
    if parts is not None:
        parts["index_ms"] = index_ms
    return busy_ms / ref_ms, busy_ms, sum(r[1] for r in rows)


PER_MICROBATCH = {  # kernel launches of one training microbatch (derived in PERF.md)
    # every forward call packs its weights once (with grad the backward images
    # too), and its backward reuses them: a per-tile pass and chain_wgrad (each
    # counted under its backward's name; K1's chain_wgrad as "chain_wgrad")
    "grid_raw_tpu": {
        "fused_chain": 5, "fused_chain_pack": 11,
        "fused_chain_bwd": 5, "chain_wgrad": 5,  # trunk, polarization head, background x3
        "fused_slot_sdf_value": 5, "fused_slot_sdf_value_bwd": 1,  # sampler x4, taps
        "fused_slot_sdf_value_wgrad": 1,
        "fused_slot_sdf_chain": 1, "fused_slot_sdf_chain_bwd": 1,
        "fused_slot_sdf_chain_wgrad": 1,
    },
    "mlp_raw_tpu": {
        # sampler x4 (no grad), trunk, polarization head, background x3; K4's
        # forward (the tenth pack), whose images its backward reuses
        "fused_chain": 9, "fused_chain_pack": 10,
        "fused_chain_bwd": 5, "chain_wgrad": 5,
        "fused_sdf_chain": 1, "fused_sdf_chain_bwd": 1, "fused_sdf_chain_wgrad": 1,
    },
    "grid_raw_tpu without PE": {
        # K1: the SDF head of the sampler x4 (no grad) and of the taps, trunk,
        # polarization head, background x3; K6: sampler x4, taps, render samples
        "fused_chain": 10, "fused_chain_pack": 11,  # and K5's forward's
        "fused_chain_bwd": 6, "chain_wgrad": 6,
        "slot_grid_lookup": 6, "slot_grid_lookup_bwd": 2,
        "fused_chain_adjoint": 1, "fused_chain_adjoint_bwd": 1, "fused_chain_adjoint_wgrad": 1,
    },
    # as mlp_raw_tpu, the render samples through K1t or K4j in place of K4
    "mlp_raw_tpu with contraction": {
        "fused_chain": 9, "fused_chain_pack": 10,
        "fused_chain_bwd": 5, "chain_wgrad": 5,
        "fused_chain_tangents": 1, "fused_chain_tangents_bwd": 1,
        "fused_chain_tangents_wgrad": 1,
    },
    "mlp_raw_tpu in jvp mode": {
        "fused_chain": 9, "fused_chain_pack": 10,
        "fused_chain_bwd": 5, "chain_wgrad": 5,
        "fused_sdf_chain_jvp": 1, "fused_sdf_chain_jvp_bwd": 1, "fused_sdf_chain_jvp_wgrad": 1,
    },
    # as grid_raw_tpu, the taps' and the render samples' backwards split:
    # K2s and K3s in place of the merged K2/K3 backwards, one scatter each
    "grid_raw_tpu with split backward": {
        "fused_chain": 5, "fused_chain_pack": 11,
        "fused_chain_bwd": 5, "chain_wgrad": 5,
        "fused_slot_sdf_value": 5, "fused_slot_sdf_value_bwd_sample": 1,
        "fused_slot_sdf_value_wgrad": 1,
        "fused_slot_sdf_chain": 1, "fused_slot_sdf_chain_bwd_sample": 1,
        "fused_slot_sdf_chain_wgrad": 1, "slot_table_scatter": 2,
    },
    # as grid_raw_tpu and its split, through the f32 table's kernels
    "grid_raw_tpu with f32 table": {
        "fused_chain": 5, "fused_chain_pack": 11,
        "fused_chain_bwd": 5, "chain_wgrad": 5,
        "fused_slot_sdf_value_f32": 5, "fused_slot_sdf_value_f32_bwd": 1,
        "fused_slot_sdf_value_wgrad": 1,
        "fused_slot_sdf_chain_f32": 1, "fused_slot_sdf_chain_f32_bwd": 1,
        "fused_slot_sdf_chain_wgrad": 1,
    },
    "grid_raw_tpu with f32 table and split backward": {
        "fused_chain": 5, "fused_chain_pack": 11,
        "fused_chain_bwd": 5, "chain_wgrad": 5,
        "fused_slot_sdf_value_f32": 5, "fused_slot_sdf_value_f32_bwd_sample": 1,
        "fused_slot_sdf_value_wgrad": 1,
        "fused_slot_sdf_chain_f32": 1, "fused_slot_sdf_chain_f32_bwd_sample": 1,
        "fused_slot_sdf_chain_wgrad": 1, "slot_table_scatter_f32": 2,
    },
    # as grid_raw_tpu without PE, the lookups through K6v (no launch of K6)
    "grid_raw_tpu without PE, vertex layout": {
        "fused_chain": 10, "fused_chain_pack": 11,
        "fused_chain_bwd": 6, "chain_wgrad": 6,
        "slot_grid_lookup_vertex": 6, "slot_grid_lookup_vertex_bwd": 2,
        "fused_chain_adjoint": 1, "fused_chain_adjoint_bwd": 1, "fused_chain_adjoint_wgrad": 1,
    },
    **{label: {} for label in REFERENCE_LABELS},
    # as grid_raw_tpu without the background's three K1 chains
    VOLSDF_LABEL: {
        "fused_chain": 2, "fused_chain_pack": 8, "fused_chain_bwd": 2, "chain_wgrad": 2,
        "fused_slot_sdf_value": 5, "fused_slot_sdf_value_bwd": 1,
        "fused_slot_sdf_value_wgrad": 1,
        "fused_slot_sdf_chain": 1, "fused_slot_sdf_chain_bwd": 1,
        "fused_slot_sdf_chain_wgrad": 1,
    },
}


# rel-L2 limit of the camera-pose gradient of the card's microbatch against
# the CPU's. That gradient is a small sum of large cancelling per-sample
# terms. On mlp_raw_tpu these carry the eikonal loss's second derivatives
# through the 8-layer SoftplusQuad SDF, and the CPU run moves by ~1e-1 when
# its parameters move by 1e-5 (printed beside each group), so its limit is
# 3e-1, as on its contraction and jvp-mode variants; so is the vertex
# table's, whose CPU run moves by 2.2e-1 under the same move (the card read
# 9.8e-2). Every other group, and grid_raw_tpu's poses, keep 1e-1.
# On the float32 reference labels every other group is held to the noise-derived limit, the
# camera poses to 5e-2: their gradient sums each background sample's position gradient through
# the background's encoding (frequencies up to 2^5), and on the card one sample's position
# gradient came out 5.5e-2 off the CPU's while the background field's outputs agreed to 1e-6
# (a ReLU pre-activation that float32 rounding puts on the other side of zero would do it),
# which moved the pose gradient by about 1.2e-2, more than 1e-6 moves of the parameters do
# (PERF.md §6, the reference methods' entry; with the background off the card and the CPU
# agree to 1.8e-5).
POSE_TOL = {"grid_raw_tpu": 1e-1, "mlp_raw_tpu": 3e-1, "grid_raw_tpu without PE": 1e-1,
            "mlp_raw_tpu with contraction": 3e-1, "mlp_raw_tpu in jvp mode": 3e-1,
            "grid_raw_tpu with split backward": 1e-1, "grid_raw_tpu with f32 table": 1e-1,
            "grid_raw_tpu with f32 table and split backward": 1e-1,
            "grid_raw_tpu without PE, vertex layout": 3e-1, VOLSDF_LABEL: 1e-1,
            **{label: 5e-2 for label in REFERENCE_LABELS}}


def _param_groups(named):
    """Parameter names grouped by module: each table (by its grid), the
    variance, each MLP."""
    groups = {}
    for k in named:
        parts = k.split(".")
        g = (".".join(parts[:-1]) if parts[-1] == "table" else "variance"
             if parts[0] == "variance" else
             ".".join(p for p in parts[:-1] if not p.startswith("layer_")))
        groups.setdefault(g, []).append(k)
    return groups


def timed_training(dev, card, method, steps=5, dataset=None):
    """Train `method` (a label of CONFIGS) at the bench geometry through
    train_steps: 2 warm-up steps, then `steps` timed ones, each checked for
    finite losses and gradients and for the parameter tensors it changed,
    and one profiled step. Returns (the run's objects with the names of the
    parameters a checked step changed, its stats: launches, rays/s, step
    ms, the peak device memory of the timed steps, busy share, busy ms,
    device ops and index kernels' ms of the profiled step). `dataset`
    (default: the 10-view, 256 x 256 synthetic scene) is the one trained on.
    chip_ab.py --train times this alone, for a paired run of two commits."""
    from multimodalstudio_tpu_torch.cameras.camera_optimizer import init_camera_poses
    from multimodalstudio_tpu_torch.configs.methods import FIVE_MODALITIES
    from multimodalstudio_tpu_torch.data.device_cache import build_device_cache
    from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset
    from multimodalstudio_tpu_torch.engine import train as T
    from multimodalstudio_tpu_torch.models.model import MMSModel
    from multimodalstudio_tpu_torch.ops.kernels import build

    cfg = load(method)
    dm = cfg.datamanager
    if (dm.num_rays_per_modality, dm.microbatch_rays, cfg.max_num_iterations) != (2048, 512, 100000):
        fail(f"{method} no longer has the bench geometry")
    microbatches = dm.num_rays_per_modality // dm.microbatch_rays
    if dataset is None:
        dataset = make_synthetic_dataset(FIVE_MODALITIES, num_views=10, height=256, width=256,
                                         raw=dm.raw, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = MMSModel(cfg.model, device=dev).init(gen)
    num_cameras = {m: dataset.data[m].cameras.camera_to_worlds.shape[0] for m in FIVE_MODALITIES}
    poses = init_camera_poses(dm.camera_optimizer, FIVE_MODALITIES, num_cameras, device=dev)
    state = T.init_train_state(cfg, model, poses)
    cache = build_device_cache(dataset, device=dev)
    cams = {m: dataset.data[m].cameras for m in FIVE_MODALITIES}
    train_steps = T.make_train_steps(cfg, model, cams)
    # each parameter tensor's value before the last step, and the tensors a step has changed:
    # at the warm-up's learning rates (1e-7 to 7e-7) an update of a value near 1 is about one
    # ulp, and a sign-alternating gradient can take it back to where it started
    last = {k: p.detach().clone() for k, p in model.named_parameters()}
    moved = set()

    def check(aux, step):
        bad = [k for k, v in aux["losses"].items() if not torch.isfinite(torch.as_tensor(v)).all()]
        if bad:
            fail(f"non-finite losses {bad} at step {step}")
        if aux["metrics"]["grads_finite"] != 1.0:
            fail(f"non-finite gradient at step {step}")
        for k, p in model.named_parameters():
            if not torch.equal(p, last[k]):
                moved.add(k)
                last[k].copy_(p)

    t0 = time.perf_counter()
    for _ in range(2):  # warm-up
        state, aux = train_steps(state, cache, gen, 1)
        check(aux, state.step)
    torch.cuda.synchronize()
    print(f"  warm-up: 2 steps in {time.perf_counter() - t0:.2f} s")
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    step_s = []
    for _ in range(steps):
        t1 = time.perf_counter()
        state, aux = train_steps(state, cache, gen, 1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        check(aux, state.step)
        print(f"  step {state.step}: {step_s[-1] * 1e3:.1f} ms " + " ".join(
            f"{k}={float(v):.5g}" for k, v in sorted(aux["losses"].items())))
    seconds = sum(step_s)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    launches = {name: info.launches for name, info in build.KERNELS.items()}
    rays = dm.num_rays_per_modality * len(FIVE_MODALITIES) * steps
    rays_per_s = rays / seconds
    print(f"  trained {rays} rays in {seconds:.3f} s: {rays_per_s:.1f} rays/s (train, {method},"
          f" 5 modalities, 2048 rays per modality in {microbatches} microbatches, {card})")
    print(f"  peak device memory of a step (torch.cuda.max_memory_allocated): {peak_gib:.2f} GiB")
    parts = {}
    busy, busy_ms, ops = profile_device(lambda: train_steps(state, cache, gen, 1),
                                        "one training step", 1e3 * seconds / steps, top=20,
                                        parts=parts)
    stats = dict(launches=launches, rays_per_s=rays_per_s, step_ms=1e3 * seconds / steps,
                 peak_gib=peak_gib, busy=busy, busy_ms=busy_ms, ops=ops, **parts)
    return (cfg, model, cams, state, cache, gen, moved), stats


# the least limit of the reference labels' microbatch against the CPU's: both run float32
F32_FLOOR = 1e-3


def run_training(dev, card, method, steps=5):
    """timed_training, then check its launch counts and that every parameter
    moved; then hold one small microbatch on the card against the plain
    versions on the CPU: within fixed limits on the bf16 labels, and on the
    reference labels the loss and each gradient group within max(F32_FLOOR,
    twice the CPU run's distance to itself with every parameter moved by
    1e-6), the noise-derived limit of the JAX comparisons in the tests, the
    camera poses within max(POSE_TOL, that twice); VOLSDF_LABEL's also against
    the plain versions on the card, its table against the CPU within
    VOLSDF_TABLE_TOL."""
    import dataclasses

    from multimodalstudio_tpu_torch.configs.methods import FIVE_MODALITIES
    from multimodalstudio_tpu_torch.data.device_cache import sample_pixel_batch
    from multimodalstudio_tpu_torch.engine import train as T
    from multimodalstudio_tpu_torch.models.model import MMSModel
    from multimodalstudio_tpu_torch.ops.kernels import build

    (cfg, model, cams, state, cache, gen, stepped), stats = timed_training(dev, card, method,
                                                                           steps)
    dm = cfg.datamanager
    microbatches = dm.num_rays_per_modality // dm.microbatch_rays
    launches = stats["launches"]
    want = {name: PER_MICROBATCH[method].get(name, 0) * microbatches * steps
            for name in build.KERNELS}
    print(f"  launches {launches}, expected {want} ({microbatches} microbatches x {steps} steps)")
    if launches != want:
        fail("the training steps did not go through every kernel as often as expected")
    names = [k for k, _ in model.named_parameters()]
    print(f"  {len(stepped)} of {len(names)} parameter tensors moved in one of the {2 + steps} "
          f"checked steps; update count {state.opt_state.count}")
    if len(stepped) < len(names) or state.opt_state.count != state.step:
        fail(f"the parameters did not all move: {sorted(set(names) - stepped)}")
    if CONFIGS[method][1] == CONTRACTION:
        cross_check_k4(cfg, model, cams, state, cache, gen, dev)

    # one 64-ray microbatch on the card and through the plain versions on the CPU
    small = dataclasses.replace(cfg, datamanager=dataclasses.replace(
        dm, num_rays_per_modality=64, microbatch_rays=0))
    batch = sample_pixel_batch(cache, gen, 64, FIVE_MODALITIES)
    sched = T.make_schedules(small, state.step)
    random_colours = cfg.model.background_color == "random"
    if random_colours:
        fixed_background_colours(model)
    gpu = T.batch_loss_and_grads(small, model, cams, state.camera_poses, batch, state.step, sched)
    cpu_model = MMSModel(cfg.model, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    if random_colours:
        fixed_background_colours(cpu_model)
    cpu_cams = {m: dataclasses.replace(c, **{k: getattr(c, k).cpu() for k in
                                             ("fx", "fy", "cx", "cy", "camera_to_worlds")})
                for m, c in cams.items()}
    cpu_poses = {m: p.detach().cpu().requires_grad_(True) for m, p in state.camera_poses.items()}
    cpu_batch = {m: dataclasses.replace(b, **{f.name: getattr(b, f.name).cpu()
                                              for f in dataclasses.fields(b)})
                 for m, b in batch.items()}
    cpu = T.batch_loss_and_grads(small, cpu_model, cpu_cams, cpu_poses, cpu_batch, state.step,
                                 sched)
    # the conditioning of each group: the CPU run again with every parameter
    # moved by 1e-5 (relative), about as far as the card's other summation
    # orders move the bf16 roundings; by 1e-6 on the float32 reference labels,
    # the tests' move (one draw here, for the run's time; the tests take 3)
    f32 = method in REFERENCE_LABELS
    move = 1e-6 if f32 else 1e-5
    noise = torch.Generator().manual_seed(SEED)
    cpu_model.load_state_dict({k: v * (1 + move * torch.randn(v.shape, generator=noise))
                               for k, v in cpu_model.state_dict().items()})
    moved = [T.batch_loss_and_grads(small, cpu_model, cpu_cams, cpu_poses, cpu_batch, state.step,
                                    sched)]
    plain = None
    if method == VOLSDF_LABEL:
        with plain_kernel_calls():
            plain = T.batch_loss_and_grads(small, model, cams, state.camera_poses, batch,
                                           state.step, sched)
    # loose on the bf16 labels: importance samples move with bf16 noise, and
    # the card's sums run in other orders (atomics) than the CPU's
    rel = abs(float(gpu[0]) - float(cpu[0])) / abs(float(cpu[0]))
    loss_noise = max(abs(float(m[0]) - float(cpu[0])) / abs(float(cpu[0])) for m in moved)
    tol = max(F32_FLOOR, 2 * loss_noise) if f32 else 2e-2
    print(f"  microbatch vs CPU plain: total loss {float(gpu[0]):.6g} vs {float(cpu[0]):.6g} "
          f"(rel {rel:.3e}, tolerance {tol:.3g}; the CPU run moved by {move:g}: "
          f"{loss_noise:.3e})")
    worst = rel if rel <= tol else float("inf")
    fields_g, fields_c = gpu[3]["fields"], cpu[3]["fields"]
    groups = _param_groups(fields_c)
    groups["camera_poses"] = None
    for name, keys in groups.items():
        flat = [torch.cat([g.reshape(-1).cpu() for g in
                           (run[3]["camera_poses"].values() if keys is None
                            else [run[3]["fields"][k] for k in keys])])
                for run in (gpu, cpu, *moved)]
        r, cond = rel_l2(flat[0], flat[1]), max(rel_l2(f, flat[1]) for f in flat[2:])
        if f32:
            tol = max(POSE_TOL[method] if keys is None else F32_FLOOR, 2 * cond)
        else:
            tol = POSE_TOL[method] if keys is None else 1e-1
        if plain is not None:
            on_card = torch.cat([g.reshape(-1).cpu() for g in
                                 (plain[3]["camera_poses"].values() if keys is None
                                  else [plain[3]["fields"][k] for k in keys])])
            kern = rel_l2(flat[0], on_card)
            print(f"  microbatch vs the plain versions on the card: gradient of {name} "
                  f"rel_l2={kern:.3e} (tolerance {tol:.3g}); the plain versions, card vs CPU: "
                  f"{rel_l2(on_card, flat[1]):.3e}")
            if not kern <= tol:
                worst = float("inf")
            if keys is not None and any(k.endswith("table") for k in keys):
                tol = VOLSDF_TABLE_TOL
        print(f"  microbatch vs CPU plain: gradient of {name} rel_l2={r:.3e} (tolerance {tol:.3g}; "
              f"the CPU run against itself with parameters moved by {move:g}: {cond:.3e})")
        if not (r <= tol and torch.isfinite(flat[0]).all()):
            worst = float("inf")
    if worst == float("inf"):
        fail("the card's training microbatch disagrees with the CPU plain versions")
    if method == VOLSDF_LABEL:
        check_update_on_the_cpu(cfg, model, state, gpu[3])
    if f32:
        stats["hash_grid"] = time_hash_grids(dev, card, cfg)
    return stats


def check_update_on_the_cpu(cfg, model, state, grads, tol=1e-5):
    """One optimizer update of the run's state on the card against the same update on the
    CPU, each group within rel-L2 `tol` (both float32, the same operations)."""
    from multimodalstudio_tpu_torch.engine import train as T

    opt = T.make_optimizer(cfg)
    cpu = lambda tree: {g: {k: v.detach().cpu() for k, v in d.items()}  # noqa: E731
                        for g, d in tree.items()}
    st = state.opt_state
    card, _ = opt.update(grads, st, T.train_params(model, state.camera_poses))
    host, _ = opt.update(cpu(grads), T.OptState(count=st.count, mu=cpu(st.mu), nu=cpu(st.nu)),
                         cpu(T.train_params(model, state.camera_poses)))
    kinds = {g: a.kind for g, a in opt.groups}
    for g in card:
        a = torch.cat([card[g][k].reshape(-1).cpu() for k in host[g]])
        b = torch.cat([host[g][k].reshape(-1) for k in host[g]])
        rel = rel_l2(a, b)
        print(f"  update {st.count + 1} of {g} ({kinds[g]}) on the card vs the CPU: rel_l2={rel:.3e}"
              f" (tolerance {tol:g})")
        if not (rel <= tol and torch.isfinite(a).all()):
            fail(f"the {kinds[g]} update of {g} on the card disagrees with the CPU's")


def time_hash_grids(dev, card, cfg):
    """The plain hash grid alone on the card, for each hash grid of `cfg`:
    forward (the lookup) and backward (hash_lookup_backward: the table's
    index_add_ and the position cotangent) at one training microbatch's
    largest call, every render sample's 4 tetrahedron taps (2560 rays x 64
    samples x 4) or, where the grid is not the SDF's, its 2560 x 64 render
    samples (the background's 2560 x 16), on uniform positions with every
    level live. Bytes of the bound: x read, the 8 corner rows of every
    level read (at most the whole table once) and the features written;
    the backward also reads the cotangent and writes d table (the whole
    table) and d x. Returns {grid: (points, fwd ms, bwd ms, fwd bound ms,
    bwd bound ms)}."""
    from multimodalstudio_tpu_torch.ops.encodings import HashGridSpec, hash_lookup_backward
    from multimodalstudio_tpu_torch.ops.encodings import hash_grid_lookup

    m = cfg.model
    rays = 512 * 5
    grids = {"surface": (m.surface.surface_field.field.grid, rays * 64 * (
        m.surface.numerical_gradient_taps if m.surface.use_numerical_gradients else 1)),
             "radiance": (m.radiance.radiance_field.base_field.grid, rays * 64),
             "background": (m.background.field.base_field.grid, rays * 16)}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for name, (grid, n) in grids.items():
        if grid is None or not isinstance(grid.encoding, HashGridSpec):
            continue
        spec = grid.encoding
        table = (torch.rand(spec.num_levels * spec.table_size, spec.features_per_level,
                            generator=gen, device=dev) * 2 - 1) * spec.hash_init_scale
        x = torch.rand(n, 3, generator=gen, device=dev)
        g = torch.randn(n, spec.out_dim, generator=gen, device=dev)
        fwd = time_ms(lambda: hash_grid_lookup(table, x, spec))
        bwd = time_ms(lambda: hash_lookup_backward(table, x, spec, g))
        # the corner rows read, at most the whole table once
        rows = min(spec.num_levels * 8 * n * spec.features_per_level * 4, nbytes(table))
        fwd_bound = bound(0, rows + nbytes(x, g), H100_F32_FLOPS)[0]  # g: the output's size
        bwd_bound = bound(0, rows + nbytes(x, g) + nbytes(table, x), H100_F32_FLOPS)[0]
        print(f"  hash grid alone ({name}, {spec.num_levels} levels x 2^{spec.log2_hashmap_size}, "
              f"N = {n}): forward {fwd:.3f} ms (bound {fwd_bound:.3f}), backward {bwd:.3f} ms "
              f"(bound {bwd_bound:.3f}) ({card})")
        out[name] = (n, fwd, bwd, fwd_bound, bwd_bound)
    return out


def cross_check_k4(cfg, model, cams, state, cache, gen, dev) -> None:
    """The contraction route (K1t) against the K4 route of mlp_raw_tpu with
    the same parameters, on one training microbatch's render samples inside
    the unit cube, where the L-inf contraction is the identity, so both
    compute the same function (rel-L2 <= 5e-2). The samples of rays that hit
    the radius-1 collider sphere lie inside it; those of rays that miss it
    may not."""
    import dataclasses

    from multimodalstudio_tpu_torch.configs.methods import FIVE_MODALITIES
    from multimodalstudio_tpu_torch.data.device_cache import sample_pixel_batch
    from multimodalstudio_tpu_torch.engine import train as T
    from multimodalstudio_tpu_torch.models.model import MMSModel

    dm = cfg.datamanager
    one = dataclasses.replace(cfg, datamanager=dataclasses.replace(
        dm, num_rays_per_modality=dm.microbatch_rays, microbatch_rays=0))
    sched = T.make_schedules(one, state.step)
    batch = sample_pixel_batch(cache, gen, dm.microbatch_rays, FIVE_MODALITIES)
    captured = []
    route = model.sdf_gradients

    def capture(pos, *args, **kw):
        captured.append(pos.detach())
        return route(pos, *args, **kw)

    model.sdf_gradients = capture
    try:
        T.batch_loss_and_grads(one, model, cams, state.camera_poses, batch, state.step, sched)
    finally:
        del model.sdf_gradients
    pos = captured[0]
    k4 = MMSModel(load("mlp_raw_tpu").model, device=dev)
    k4.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = model.sdf_gradients(pos, sched, train=True)
        ref = k4.sdf_gradients(pos, sched, train=True)
    inside = pos.abs().amax(-1) < 1.0
    print(f"  contraction route vs K4 route on the {int(inside.sum())} of {inside.numel()} render "
          "samples of one training microbatch inside the unit cube:")
    for name, a, b, tol in (("sdf", got[0], ref[0], 5e-2), ("geo", got[1], ref[1], None),
                            ("grad", got[2], ref[2], 5e-2)):
        rel = rel_l2(a[inside].float(), b[inside].float())
        print(f"    {name}: rel_l2={rel:.3e}" + (f" (tolerance {tol:g})" if tol else ""))
        if tol and not (rel <= tol and torch.isfinite(a).all()):
            fail(f"the contraction route's {name} disagrees with the K4 route")


# ------------------------------------------------------ trained checkpoints and entry points

# each wrapper a rehearsal render or mesh launches, where models/ and fields/ call it, and the
# plain version its outputs are held against (rel-L2 <= 1e-2 and finite, as the kernel checks)
KERNEL_WRAPPERS = {  # wrapper: (its module, the modules that call it, its plain version)
    "fused_chain": ("fused_mlp", ("models.model", "fields.mlp"), "fused_chain_plain"),
    "fused_sdf_chain": ("sdf_chain", ("models.model",), "fused_sdf_chain_plain"),
    "fused_slot_sdf_value": ("slot_fused", ("models.model",), "slot_sdf_value_plain"),
    "fused_slot_sdf_chain": ("slot_fused", ("models.model",), "slot_sdf_chain_plain"),
}


@contextlib.contextmanager
def wrappers_replaced(replacement, names=None):
    """Each wrapper of KERNEL_WRAPPERS in `names` (default: all), in every module that calls
    it, replaced for the block by replacement(name, wrapper)."""
    import importlib

    saved = []
    for name, (_, users, _) in KERNEL_WRAPPERS.items():
        if names is not None and name not in names:
            continue
        for user in users:
            mod = importlib.import_module(f"multimodalstudio_tpu_torch.{user}")
            fn = getattr(mod, name)
            saved.append((mod, name, fn))
            setattr(mod, name, replacement(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def plain_version(name):
    """The plain PyTorch version of a KERNEL_WRAPPERS wrapper."""
    import importlib

    module, _, plain_name = KERNEL_WRAPPERS[name]
    return getattr(importlib.import_module(f"multimodalstudio_tpu_torch.ops.kernels.{module}"),
                   plain_name)


@contextlib.contextmanager
def recorded_kernel_calls():
    """Record every call of the KERNEL_WRAPPERS made through the model: a list of (wrapper,
    args, kwargs, outputs)."""
    calls = []

    def recorder(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            calls.append((name, args, kw, out))
            return out
        return call

    with wrappers_replaced(recorder):
        yield calls


def plain_kernel_calls(names=None):
    """Every call of the KERNEL_WRAPPERS in `names` (default: all) made through the model
    runs the wrapper's plain version on the same (card) tensors instead, launching nothing:
    a render through the plain versions, to hold against the kernels' render of the same
    view."""

    def plain(name, _):
        fn = plain_version(name)

        def call(*args, **kw):
            kw.pop("mode", None)
            return fn(*args, **kw)
        return call

    return wrappers_replaced(plain, names)


def check_call(what, name, args, kw, out, tol=1e-2):
    """Hold one call of a KERNEL_WRAPPERS wrapper (its args, kwargs and outputs) against its
    plain version on the same inputs, each output within rel_l2 tol; returns the max-abs
    error."""
    kw = {k: v for k, v in kw.items() if k != "mode"}
    with torch.no_grad():
        ref = plain_version(name)(*args, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    worst = 0.0
    for i, (a, b) in enumerate(zip(outs, refs)):
        a, b = a.detach().float(), b.float()
        rel = rel_l2(a, b)
        worst = max(worst, float((a - b).abs().max()))
        if not (rel <= tol and torch.isfinite(a).all()):
            fail(f"{what}: {name} output {i} (N={args[0].shape[0]}) disagrees with its plain "
                 f"version on the same inputs: rel_l2={rel:.3e} (tolerance {tol:g})")
    return worst


def report_calls(what, counts, worst, tol):
    """Print the checked calls by wrapper and their largest max-abs errors; fails if none."""
    if not counts:
        fail(f"{what}: no kernel was called")
    print(f"  {what}: {sum(counts.values())} kernel calls held against their plain versions "
          f"({counts}), each output within rel_l2 {tol:g}; max_abs " +
          " ".join(f"{n}={e:.3e}" for n, e in worst.items()))


def check_recorded_calls(what, calls, tol=1e-2):
    """Hold each recorded kernel call against its plain version on the same inputs; returns
    the largest max-abs error by wrapper."""
    worst, counts = {}, {}
    for name, args, kw, out in calls:
        worst[name] = max(worst.get(name, 0.0), check_call(what, name, args, kw, out, tol))
        counts[name] = counts.get(name, 0) + 1
    report_calls(what, counts, worst, tol)
    return worst


@contextlib.contextmanager
def first_step_checked(what, tol=1e-2):
    """engine/train.py::make_train_steps wrapped for the block: the first call of each
    train_steps it makes runs with every KERNEL_WRAPPERS call held, as it is made, against
    its plain version on the same inputs (check_call; the plain runs launch nothing). Yields
    the largest max-abs errors by wrapper, filled as the step runs."""
    from multimodalstudio_tpu_torch.engine import train

    make, worst, counts = train.make_train_steps, {}, {}

    def checker(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            worst[name] = max(worst.get(name, 0.0), check_call(what, name, args, kw, out, tol))
            counts[name] = counts.get(name, 0) + 1
            return out
        return call

    def checked_make(*args, **kw):
        train_steps, first = make(*args, **kw), [True]

        def steps(*a, **k):
            if not first:
                return train_steps(*a, **k)
            first.clear()
            with wrappers_replaced(checker):
                return train_steps(*a, **k)
        return steps

    train.make_train_steps = checked_make
    try:
        yield worst
    finally:
        train.make_train_steps = make
    report_calls(what, counts, worst, tol)


def results_block(run, step):
    """{modality: {metric: value}} of the results.txt block at `step` of a run."""
    out, block = {}, None
    with open(os.path.join(run, "results.txt")) as f:
        for line in f:
            if line.startswith("step "):
                block = int(line.split()[1])
            elif block == step and line.strip():
                mod, _, vals = line.strip().partition(": ")
                out[mod] = {k: float(v) for k, v in (kv.split("=") for kv in vals.split())}
    if not out:
        fail(f"{run}/results.txt has no block at step {step}")
    return out


def rehearsal_scene(dev):
    """The 36-view, 256 x 256 raw scene the rehearsals trained on (train, eval)."""
    import rehearsals
    from multimodalstudio_tpu_torch import launcher

    return launcher.build_datasets(rehearsals.rehearsal_config("rehearsal_mlp_dense"),
                                   rehearsals.SCENE, device=dev)


def load_rehearsal(dev, name, datasets):
    """(config, model, state) of a rehearsal run: its weights file through
    engine/checkpoints.py into a model of its config, channels bound by the dataset."""
    import rehearsals
    from multimodalstudio_tpu_torch import launcher
    from multimodalstudio_tpu_torch.cameras.camera_optimizer import init_camera_poses
    from multimodalstudio_tpu_torch.engine import checkpoints
    from multimodalstudio_tpu_torch.engine.train import TrainState
    from multimodalstudio_tpu_torch.models.model import MMSModel

    r = rehearsals.REHEARSALS[name]
    cfg = launcher.resolve_model_channels(rehearsals.rehearsal_config(name), datasets[0])
    model = MMSModel(cfg.model, device=dev)
    num_cameras = {m: datasets[0].num_frames(m) for m in cfg.modalities}
    poses = init_camera_poses(cfg.datamanager.camera_optimizer, cfg.modalities, num_cameras,
                              device=dev)
    state, next_step = checkpoints.load_checkpoint(os.path.join(r["run"], "checkpoints"), model,
                                                   TrainState(camera_poses=poses, step=0),
                                                   r["step"])
    if state.step != r["step"] or next_step != r["step"] + 1 or state.opt_state is not None:
        fail(f"{name}: the weights file did not load as step {r['step']} without optimizer state")
    return cfg, model, state


@contextlib.contextmanager
def all_eval_views():
    """MMS_EVAL_MAX_VIEWS unset while a render scores every eval view."""
    saved = os.environ.pop("MMS_EVAL_MAX_VIEWS", None)
    try:
        yield
    finally:
        if saved is not None:
            os.environ["MMS_EVAL_MAX_VIEWS"] = saved


def mosaicked_psnr(vals):
    return vals.get("psnr_mosaicked", vals["psnr"])


def run_checkpoint(dev, card, name, datasets):
    """Phase A for one rehearsal run: the kernels of view 0's central eval chunk against
    their plain versions on the trained inputs, then every eval view through
    RawEvaluator.render_all_eval_views at rendering_scale 1 in chunks of 4096, the launch
    counts, each modality's metrics beside the JAX package's eval of the same weights in
    the run's results.txt, and each view's mosaicked PSNR. Then, where results.txt scores
    the same weights, every eval view again through the plain versions on the card, an
    uncounted witness of where a gap to JAX's eval lies (it fails when a modality's mosaicked
    PSNR through the kernels is more than 1.0 dB below it, the limit held against JAX's).
    Returns (launches, rays/s, metrics, max-abs errors of the central chunk's kernels)."""
    import rehearsals
    from multimodalstudio_tpu_torch.data.sampler import dense_pixel_batch
    from multimodalstudio_tpu_torch.engine.evaluator import RawEvaluator
    from multimodalstudio_tpu_torch.ops.kernels import build

    r = rehearsals.REHEARSALS[name]
    cfg, model, state = load_rehearsal(dev, name, datasets)
    ev = RawEvaluator(cfg, model, datasets[0], datasets[1], device=dev)
    chunk = cfg.evaluator.eval_num_rays_per_chunk
    if (cfg.evaluator.rendering_scale, chunk) != (1.0, 4096):
        fail(f"{name}: not the run's eval geometry")

    # the central chunk of view 0, through the sphere's silhouette and surface
    batch = dense_pixel_batch(datasets[1], "rgb", 0, 1.0)
    mid = batch.pixel_coords.shape[0] // chunk // 2 * chunk
    with recorded_kernel_calls() as calls:
        ev._render_chunk(state, "rgb", datasets[1].data["rgb"].cameras,
                         batch.camera_indices[mid:mid + chunk], batch.pixel_coords[mid:mid + chunk])
    errs = check_recorded_calls(f"{name}, central eval chunk", calls)
    del calls

    # each view's metrics as render_all_eval_views scores them
    per_view = {}

    def recording(frames, mod, _score=ev.view_metrics):
        vals = _score(frames, mod)
        per_view.setdefault(mod, []).append(vals)
        return vals

    ev.view_metrics = recording
    with all_eval_views():
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        results = ev.render_all_eval_views(state)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    del ev.view_metrics
    launches = {n: info.launches for n, info in build.KERNELS.items()}
    views = {m: datasets[1].num_frames(m) for m in cfg.modalities}
    cams = datasets[1].data["rgb"].cameras
    per_image = -(-cams.height * cams.width // chunk)
    chunks = per_image * sum(views.values())
    want = {n: PER_CHUNK[REHEARSAL_LABELS[name]].get(n, 0) * chunks for n in build.KERNELS}
    print(f"  launches {launches}, expected {want} for {chunks} chunks of {chunk} rays")
    if launches != want or not any(launches.values()):
        fail(f"{name}: the render did not go through every kernel as often as expected")
    n_rays = cams.height * cams.width * sum(views.values())
    print(f"  rendered {sum(views.values())} views, {n_rays} rays in {seconds:.3f} s: "
          f"{n_rays / seconds:.1f} rays/s (eval, {name} step {state.step}, {card})")

    jax = results_block(r["run"], r["jax_step"])
    gap = "" if r["jax_step"] == r["step"] else (
        f"; the weights are step {r['step']}, {r['step'] - r['jax_step']} steps past that block, "
        "so the columns are not the same weights")
    print(f"  metrics (port, this run) beside the JAX package's eval in results.txt at step "
          f"{r['jax_step']}{gap}:")
    for mod, vals in results.items():
        ref = jax.get(mod, {})
        print(f"    {mod}: " + "  ".join(
            f"{k}={v:.4f}" + (f" (JAX {ref[k]:.4f}, {v - ref[k]:+.4f})" if k in ref else "")
            for k, v in vals.items()))
        psnr = mosaicked_psnr(vals)
        if not all(np.isfinite(v) for v in vals.values()):
            fail(f"{name}: non-finite metrics for {mod}")
        if r["jax_step"] == r["step"]:
            jpsnr = mosaicked_psnr(ref)
            if psnr < jpsnr - 1.0:
                fail(f"{name}: {mod} mosaicked PSNR {psnr:.4f} is more than 1.0 dB below the "
                     f"JAX package's {jpsnr:.4f}")
        elif psnr < 30.0:
            fail(f"{name}: {mod} mosaicked PSNR {psnr:.4f} is under 30 dB")
    print("  mosaicked PSNR of each eval view (view 0 first):")
    for mod, vals in per_view.items():
        print(f"    {mod}: " + " ".join(f"{mosaicked_psnr(v):.4f}" for v in vals))

    if r["jax_step"] != r["step"]:
        return launches, n_rays / seconds, results, errs
    t0 = time.perf_counter()
    build.reset_launch_counts()
    with plain_kernel_calls(), all_eval_views():
        plain = ev.render_all_eval_views(state)
    torch.cuda.synchronize()
    if any(info.launches for info in build.KERNELS.values()):
        fail(f"{name}: the plain versions' render launched a kernel")
    print(f"  every eval view again through the plain versions on the card "
          f"({time.perf_counter() - t0:.1f} s), mosaicked PSNR:")
    for mod, vals in plain.items():
        k, p, j = mosaicked_psnr(results[mod]), mosaicked_psnr(vals), mosaicked_psnr(jax[mod])
        print(f"    {mod}: kernels {k:.4f}, plain {p:.4f} (kernels {k - p:+.4f}); JAX {j:.4f} "
              f"(plain {p - j:+.4f})")
        if not (np.isfinite(p) and k >= p - 1.0):
            fail(f"{name}: {mod} mosaicked PSNR through the kernels, {k:.4f}, is more than 1.0 dB "
                 f"below the plain versions' {p:.4f}")
    return launches, n_rays / seconds, results, errs


def ply_vertices(path):
    """(vertices [V, 3], face count) of an ASCII PLY mesh."""
    with open(path) as f:
        header = []
        for line in f:
            header.append(line.split())
            if line.startswith("end_header"):
                break
        counts = {h[1]: int(h[2]) for h in header if h[0] == "element"}
        verts = np.loadtxt(f, max_rows=counts["vertex"], dtype=np.float64, ndmin=2)
    return verts.reshape(-1, 3), counts.get("face", 0)


def run_mesh(dev, card, name, datasets, resolution=256):
    """Phase B: export_mesh of a rehearsal run at `resolution`: its first 262,144-point SDF
    chunk against the plain version, the launches, and the mesh against the scene's sphere
    of radius 0.5 at the origin (data/synthetic.py)."""
    import tempfile

    from multimodalstudio_tpu_torch.engine.evaluator import RawEvaluator
    from multimodalstudio_tpu_torch.engine.train import make_schedules
    from multimodalstudio_tpu_torch.ops.kernels import build

    cfg, model, state = load_rehearsal(dev, name, datasets)
    cfg = dataclasses.replace(cfg, evaluator=dataclasses.replace(cfg.evaluator,
                                                                 mesh_resolution=resolution))
    lo, hi = -cfg.model.scene_radius, cfg.model.scene_radius
    xs = np.linspace(lo, hi, resolution, dtype=np.float32)
    grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1).reshape(-1, 3)[:262144]
    active = make_schedules(cfg, state.step).active_level
    with recorded_kernel_calls() as calls, torch.no_grad():
        model.sdf_only(torch.as_tensor(grid, device=dev), active)
    errs = check_recorded_calls(f"{name}, first mesh chunk", calls)
    del calls
    with tempfile.TemporaryDirectory() as out:
        ev = RawEvaluator(cfg, model, datasets[0], datasets[1], out, device=dev)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        path = ev.export_mesh(state, state.step)
        seconds = time.perf_counter() - t0
        launches = {n: info.launches for n, info in build.KERNELS.items()}
        verts, n_faces = ply_vertices(path)
    chunks = -(-resolution ** 3 // 262144)
    kernel = ("fused_slot_sdf_value_f32" if "f32" in REHEARSAL_LABELS[name]
              else "fused_slot_sdf_value")
    want = {n: chunks if n in (kernel, "fused_chain_pack") else 0 for n in build.KERNELS}
    err = np.abs(np.linalg.norm(verts, axis=-1) - 0.5)
    spacing = (hi - lo) / (resolution - 1)
    med, p95 = float(np.median(err)), float(np.percentile(err, 95))
    print(f"  mesh at {resolution}^3 in {seconds:.2f} s: {len(verts)} vertices, {n_faces} faces; "
          f"| |v| - 0.5 | median {med:.3e}, 95th percentile {p95:.3e} ({med / spacing:.3f} and "
          f"{p95 / spacing:.3f} grid spacings of {spacing:.3e}); launches {launches}, expected "
          f"{want} ({card})")
    if launches != want:
        fail(f"{name}: the mesh's SDF did not go through {kernel} once a chunk")
    if not (len(verts) > 0 and n_faces > 0 and med <= 2 * spacing):
        fail(f"{name}: the mesh is not the scene's sphere (median radial error {med:.3e} > "
             f"2 grid spacings)")
    return launches, errs


ENTRY_SCENE = "synthetic_raw:views=12,size=96"
# every cadence of a Trainer once in 20 steps, the demosaicked regimes scored (phase C)
EVERY_CADENCE = {
    "max_num_iterations": 20, "steps_per_eval_batch": 20, "steps_per_eval_image": 20,
    "steps_per_eval_all_images": 20, "steps_per_save": 20, "steps_per_export_mesh": 20,
    "steps_per_export_poses": 20,
    "evaluator": {"export_mesh": True, "export_poses": True, "mesh_resolution": 128,
                  "rendering_scale": 1.0},
    "logging": {"steps_per_log": 20, "steps_per_flush_buffer": 20},
}


def run_entry_points(dev, card, root):
    """Phase C: grid_raw_tpu at full width through the port's own entry points in `root`:
    launcher --mode train for 10 steps (a whole-state checkpoint), a Trainer whose every
    cadence fires once in 20 steps resuming from it, then launcher --mode eval on the same
    run; checks resume steps and outputs. Returns the launches."""
    import glob

    from multimodalstudio_tpu_torch import launcher
    from multimodalstudio_tpu_torch.configs.config import load_config
    from multimodalstudio_tpu_torch.engine import checkpoints
    from multimodalstudio_tpu_torch.engine.trainer import Trainer
    from multimodalstudio_tpu_torch.ops.kernels import build

    args = ["--method", "grid_raw_tpu", "--scene", ENTRY_SCENE, "--version", "smoke",
            "--output", root, "--device", str(dev)]
    run = os.path.join(root, "synthetic_raw", "grid_raw_tpu", "grid_raw_tpu", "smoke")
    ckpts = os.path.join(run, "checkpoints")
    build.reset_launch_counts()
    launches = {}

    def add_launches():
        for n, info in build.KERNELS.items():
            launches[n] = launches.get(n, 0) + info.launches
        build.reset_launch_counts()

    t0 = time.perf_counter()
    launcher.main(["--mode", "train", *args, "--max_iterations", "10"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    add_launches()
    first = checkpoints.latest_checkpoint_step(ckpts)
    ckpt = torch.load(checkpoints.checkpoint_path(ckpts, first), weights_only=True)
    print(f"  launcher --mode train: 10 steps in {train_s:.1f} s ({10 * 2048 * 5 / train_s:.1f} "
          f"rays/s with its set-up, {card}), saved step {first} with optimizer state count "
          f"{ckpt.get('opt_state', {}).get('count')}")
    if first != 10 or ckpt.get("opt_state", {}).get("count") != 10:
        fail("launcher --mode train did not save a whole-state checkpoint at step 10")

    t0 = time.perf_counter()
    cfg = load_config(method="grid_raw_tpu", overrides=EVERY_CADENCE)
    train, evald = launcher.build_datasets(cfg, ENTRY_SCENE, device=dev)
    cfg = launcher.resolve_model_channels(cfg, train)
    trainer = Trainer(cfg, train, evald, run, device=dev)
    trainer.setup()
    resumed = (trainer.state.step, trainer.step_start, trainer.state.opt_state.count)
    trainer.train()
    torch.cuda.synchronize()
    add_launches()
    second = checkpoints.latest_checkpoint_step(ckpts)
    print(f"  Trainer, every cadence once: resumed at state step {resumed[0]} (next step "
          f"{resumed[1]}, update count {resumed[2]}), trained to step {trainer.state.step} in "
          f"{time.perf_counter() - t0:.1f} s, saved step {second}")
    if resumed != (first, first + 1, first) or second != trainer.state.step:
        fail("the Trainer did not resume from the launcher's checkpoint")

    t0 = time.perf_counter()
    results = launcher.main(["--mode", "eval", *args])
    torch.cuda.synchronize()
    add_launches()
    with open(os.path.join(run, "results.txt")) as f:
        newest = int(f.readline().split()[1])
    print(f"  launcher --mode eval in {time.perf_counter() - t0:.1f} s at step {newest}: "
          + "; ".join(f"{m} psnr={v['psnr']:.3f}" for m, v in results.items()))
    if newest != second:
        fail(f"launcher --mode eval scored step {newest}, not the saved step {second}")
    found = {what: sorted(glob.glob(os.path.join(run, pattern))) for what, pattern in (
        ("checkpoints", "checkpoints/step-*.pt"), ("results", "results.txt"),
        ("renders", "renders/step-*/*/*.png"), ("demosaicked renders",
                                                 "renders/step-*/demosaicked/*/*.png"),
        ("meshes", "meshes/step-*.ply"), ("poses", "poses/step-*.ply"),
        ("config", "config.yaml"))}
    print("  outputs: " + ", ".join(f"{len(v)} {k}" for k, v in found.items()))
    missing = [k for k, v in found.items() if not v]
    if missing:
        fail(f"the entry points wrote no {missing}")
    if not all(np.isfinite(v).all() for m in results.values() for v in m.values()):
        fail("launcher --mode eval gave non-finite metrics")
    return launches


DISK_SCENE = dict(num_views=12, height=96, width=96)  # ENTRY_SCENE's geometry
K123 = ("fused_chain", "fused_slot_sdf_value", "fused_slot_sdf_chain")
CAPTURE_FRAME = 2048  # the side of a capture's 16-bit greyscale frame whose decode is timed


def time_capture_decode(card, repeats=3):
    """Host ms for read_png's decode of one CAPTURE_FRAME-square 16-bit greyscale frame
    (a smooth image with noise, from SEED), median of `repeats`, for each way its rows may
    be filtered: Sub on every row, as cv2.imwrite writes (running sums along the rows), and
    the five filters in turn, as writers that choose each row's filter give (Average and
    Paeth rows: the anti-diagonal wavefront). Each decode must return the frame."""
    import numpy as np

    from multimodalstudio_tpu_torch.utils.images import decode_png, encode_png16

    n = CAPTURE_FRAME
    y, x = np.mgrid[0:n, 0:n]
    noise = np.random.default_rng(SEED).normal(scale=300.0, size=x.shape)
    frame = (20000 + 9000 * np.sin(x / 97.0) * np.cos(y / 61.0) + noise).clip(0, 65535)
    frame = frame.astype(np.uint16)
    ms = {}
    for name, kinds in (("sub", None), ("mixed", np.arange(n) % 5)):
        blob = encode_png16(frame, kinds)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            got = decode_png(blob)
            times.append(time.perf_counter() - t0)
            if not np.array_equal(got, frame):
                fail(f"read_png's decode of the {name}-filtered capture frame differs")
        ms[name] = 1e3 * float(np.median(times))
    print(f"  a {n} x {n} 16-bit greyscale frame decodes in {ms['sub']:.1f} ms with Sub rows (as "
          f"cv2 writes) and {ms['mixed']:.1f} ms with the five filters in turn (median of "
          f"{repeats}; host; {card})")
    return ms


SAMPLER_RAYS = 2048  # rays per modality of the host sampler's timed batch (the bench's)


def time_host_sampler(card, dataset, repeats=10):
    """Host ms of one 2048-ray x 5-modality batch's draws and gathers from `dataset`'s frames
    (data/native.py::sample_pixels), the native sampler on the port's sampler's THREADS
    against its plain numpy version, the median of `repeats` after one warm-up; the native
    draws checked against the frames."""
    from multimodalstudio_tpu_torch.data import native, sampler

    def batch(plain):
        for i, mod in enumerate(dataset.modalities):
            d = dataset.data[mod]
            out = native.sample_pixels(d.images, d.mosaick_mask, SAMPLER_RAYS, SEED + i,
                                       d.cameras.pixel_offset, threads=sampler.THREADS,
                                       plain=plain)
        return out, d

    ms = {}
    for plain in (False, True):
        batch(plain)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            (fi, co, px, ch), d = batch(plain)
            times.append(time.perf_counter() - t0)
        ms["numpy" if plain else "native"] = 1e3 * float(np.median(times))
        y, x = (co[:, 0] - 0.5).astype(np.int64), (co[:, 1] - 0.5).astype(np.int64)
        if not (np.array_equal(px, d.images[fi, y, x]) and np.array_equal(ch, d.mosaick_mask[y, x])):
            fail(f"the {'numpy' if plain else 'native'} sampler's pixels are not the frames'")
    print(f"  host sampler, {SAMPLER_RAYS} rays x {len(dataset.modalities)} modalities from "
          f"{dataset.num_frames(dataset.modalities[0])} frames of "
          f"{dataset.data[dataset.modalities[0]].images.shape[1:]}: native {ms['native']:.3f} ms "
          f"(sampler.THREADS = {sampler.THREADS}), numpy {ms['numpy']:.3f} ms (median of "
          f"{repeats}; host; {card})")
    return ms


def score_disk_renders(dev, card, cfg, scene, run, train, evald):
    """Phase D's paper metrics: the eval views of the trained run rendered at
    rendering_scale 1.0 through the port's Trainer (eval from the run's checkpoint) and
    exported, then scored by the port's evaluate_average_metrics on the scene directory;
    every regime's PSNR, SSIM and LPIPS must be finite. LPIPS of one render on the card
    within rel 1e-4 of the CPU's. Returns (the metrics, the LPIPS pair)."""
    from multimodalstudio_tpu_torch import launcher
    from multimodalstudio_tpu_torch.engine.trainer import Trainer
    from multimodalstudio_tpu_torch.scripts import evaluate_average_metrics
    from multimodalstudio_tpu_torch.utils.lpips import lpips

    rp = dataclasses.replace
    out = os.path.join(os.path.dirname(run), "scored")
    os.makedirs(out, exist_ok=True)
    ecfg = rp(launcher.resolve_model_channels(cfg, train),
              load_dir=os.path.join(run, "checkpoints"),
              evaluator=rp(cfg.evaluator, rendering_scale=1.0, export_mesh=False,
                           export_poses=False))
    trainer = Trainer(ecfg, train, evald, out, device=dev)
    trainer.setup()
    trainer.eval()
    mods = list(cfg.modalities)
    renders = os.path.join(out, "renders", f"step-{trainer.state.step:09d}")
    views = [int(i) for i in evald.data[mods[0]].frame_ids]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # its JSON goes to metrics.json
        metrics = evaluate_average_metrics.main(
            ["--renders", renders, "--scene", scene, "--modalities", *mods, "--views",
             *map(str, views), "--rendering_scale", "1.0", "--device", str(dev),
             "--out", os.path.join(out, "metrics.json")])
    score_s = time.perf_counter() - t0
    regimes = ("mosaicked", "demosaicked", "rendered_demosaicked")
    for m in mods:
        for regime in regimes:
            for metric in ("psnr", "ssim", "lpips"):
                v = metrics[m].get(f"{metric}_{regime}")
                if v is None or not np.isfinite(v):
                    fail(f"evaluate_average_metrics: {m} {metric}_{regime} is {v}")
    print(f"  evaluate_average_metrics on {len(views)} eval view(s) a modality at scale 1.0 in "
          f"{score_s:.2f} s (LPIPS weights: {metrics['lpips_weights']}): " + "; ".join(
              f"{m} psnr {metrics[m]['psnr_mosaicked']:.3f} / {metrics[m]['psnr_demosaicked']:.3f}"
              f" / {metrics[m]['psnr_rendered_demosaicked']:.3f}, ssim "
              f"{metrics[m]['ssim_mosaicked']:.4f}, lpips {metrics[m]['lpips_mosaicked']:.4f}"
              for m in mods))
    pred = np.load(os.path.join(renders, "rgb", "0000_render.npy"))
    gt = evald.data["rgb"].images[0]
    x0, x1 = pred[..., :3] * 2.0 - 1.0, np.repeat(gt, 3, -1) * 2.0 - 1.0
    on_card = float(lpips(x0, x1, device=dev)[0])
    on_cpu = float(lpips(x0, x1, device="cpu")[0])
    rel = abs(on_card - on_cpu) / abs(on_cpu)
    print(f"  LPIPS of the rgb render against its frame: card {on_card:.8f}, CPU {on_cpu:.8f}, "
          f"rel {rel:.3e} (limit 1e-4)")
    if rel > 1e-4:
        fail("LPIPS on the card parts from the CPU's")
    return metrics, (on_card, on_cpu, rel)


def run_disk_scene(dev, card, root):
    """Phase D: ENTRY_SCENE's raw 5-modality scene written to `root` by the port's
    write_synthetic_scene (16-bit PNGs, meta_data.json) and loaded through
    launcher.build_datasets: every frame within one 16-bit step of the in-memory scene,
    the cameras and mosaick masks equal; a capture-size frame's decode timed
    (time_capture_decode); then launcher --mode train for 10 steps and
    --mode eval on the directory, K1, K2 and K3 launched; then timed_training on the disk
    scene's train split. Returns (the launches, the timed training's stats)."""
    import numpy as np

    from multimodalstudio_tpu_torch import launcher
    from multimodalstudio_tpu_torch.configs.config import load_config
    from multimodalstudio_tpu_torch.data.sampler import dense_pixel_batch
    from multimodalstudio_tpu_torch.data.synthetic import (
        make_synthetic_dataset,
        write_synthetic_scene,
    )
    from multimodalstudio_tpu_torch.engine import checkpoints
    from multimodalstudio_tpu_torch.ops.kernels import build

    cfg = load_config(method="grid_raw_tpu")
    mods = cfg.modalities
    scene = os.path.join(root, "scene")
    t0 = time.perf_counter()
    write_synthetic_scene(scene, mods, raw=True, **DISK_SCENE)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train, evald = launcher.build_datasets(cfg, scene, device=dev)
    load_s = time.perf_counter() - t0
    n_frames = sum(d.num_frames(m) for d in (train, evald) for m in mods)
    print(f"  wrote the scene in {write_s:.2f} s; launcher.build_datasets loaded {n_frames} frames "
          f"in {load_s:.3f} s, {1e3 * load_s / n_frames:.2f} ms a frame (host; {card})")
    decode_ms = time_capture_decode(card)

    # the writer truncates to uint16 as the reference's does: one 16-bit step
    limit, worst = 1.0 / 65535 + 1e-7, 0.0
    for name, split in (("train", train), ("eval", evald)):
        ids = [int(i) for i in split.data[mods[0]].frame_ids]
        ref = make_synthetic_dataset(mods, raw=True, view_ids=ids, device=dev, **DISK_SCENE)
        for m in mods:
            d, r = split.data[m], ref.data[m]
            if [int(i) for i in d.frame_ids] != ids:
                fail(f"{name} split: {m} has views {list(d.frame_ids)}, not {ids}")
            err = float(np.abs(d.images - r.images).max())
            worst = max(worst, err)
            same = all(torch.equal(getattr(d.cameras, k), getattr(r.cameras, k))
                       for k in ("fx", "fy", "cx", "cy", "camera_to_worlds"))
            same &= all(getattr(d.cameras, k) == getattr(r.cameras, k)
                        for k in ("width", "height", "pixel_offset", "camera_type"))
            same &= d.cameras.distortion_params is None and r.cameras.distortion_params is None
            same &= (np.array_equal(d.mosaick_pattern, r.mosaick_pattern)
                     and np.array_equal(d.mosaick_mask, r.mosaick_mask))
            if not (d.images.shape == r.images.shape and err <= limit and same):
                fail(f"{name} split, {m}: the disk scene differs from the in-memory one "
                     f"(max |frame difference| {err:.3e}, limit {limit:.3e}; cameras and masks "
                     f"{'equal' if same else 'differ'})")
        across = all(np.array_equal(split.mosaick_masks_across[a][b], ref.mosaick_masks_across[a][b])
                     for a in mods for b in mods)
        if not across:
            fail(f"{name} split: the masks across modalities differ")
    print(f"  {train.num_frames(mods[0])} train and {evald.num_frames(mods[0])} eval views per "
          f"modality; every frame within {worst:.3e} of the in-memory scene (limit {limit:.3e}); "
          "cameras and mosaick masks equal")

    out = os.path.join(root, "output")
    args = ["--method", "grid_raw_tpu", "--scene", scene, "--version", "smoke", "--output", out,
            "--device", str(dev)]
    run = os.path.join(out, "scene", "grid_raw_tpu", "grid_raw_tpu", "smoke")
    launches = {}

    def add_launches():
        for n, info in build.KERNELS.items():
            launches[n] = launches.get(n, 0) + info.launches
        build.reset_launch_counts()

    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    launcher.main(["--mode", "train", *args, "--max_iterations", "10"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    add_launches()
    saved = checkpoints.latest_checkpoint_step(os.path.join(run, "checkpoints"))
    rays = 10 * cfg.datamanager.num_rays_per_modality * len(mods)
    print(f"  launcher --mode train: 10 steps in {train_s:.2f} s, {rays / train_s:.1f} rays/s with "
          f"its set-up (load, device cache, checkpoint), saved step {saved} ({card})")
    if saved != 10:
        fail("launcher --mode train on the scene directory did not save step 10")
    t0 = time.perf_counter()
    results = launcher.main(["--mode", "eval", *args])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    add_launches()
    scale = cfg.evaluator.rendering_scale
    eval_rays = sum(dense_pixel_batch(evald, m, i, scale).pixel_coords.shape[0]
                    for m in mods for i in range(evald.num_frames(m)))
    with open(os.path.join(run, "results.txt")) as f:
        newest = int(f.readline().split()[1])
    print(f"  launcher --mode eval at step {newest}: {eval_rays} rays in {eval_s:.2f} s, "
          f"{eval_rays / eval_s:.1f} rays/s with its set-up ({card}); "
          + "; ".join(f"{m} psnr={v['psnr']:.3f}" for m, v in results.items()))
    if newest != 10 or set(results) != set(mods):
        fail("launcher --mode eval did not score every modality at step 10")
    if not all(np.isfinite(v) for m in results.values() for v in m.values()):
        fail("launcher --mode eval on the scene directory gave non-finite metrics")
    print(f"  launches of the two calls: {launches}")
    if not all(launches.get(k, 0) > 0 for k in K123):
        fail(f"the disk run did not launch each of {K123}")
    build.reset_launch_counts()
    metrics, lpips_pair = score_disk_renders(dev, card, cfg, scene, run, train, evald)
    add_launches()
    sampler_ms = time_host_sampler(card, train)

    print("  the bench-geometry training (as grid_raw_tpu's) on the disk scene's train split:")
    with config_env("grid_raw_tpu"):
        _, stats = timed_training(dev, card, "grid_raw_tpu", dataset=train)
    for n, c in stats["launches"].items():
        launches[n] = launches.get(n, 0) + c
    stats.update(load_s=load_s, frames=n_frames, decode_ms=decode_ms, launcher_train_s=train_s,
                 launcher_rays_per_s=rays / train_s, eval_rays_per_s=eval_rays / eval_s,
                 sampler_ms=sampler_ms, lpips=lpips_pair,
                 paper_metrics={m: metrics[m]["lpips_mosaicked"] for m in cfg.modalities})
    return launches, stats


# phase E: data parallel over DP_RANKS processes on one card, over gloo (NCCL refuses two ranks
# on one device); each collective raises after DP_COLLECTIVE_S, the ranks are ended after DP_RANKS_S
DP_RANKS = 2
DP_STEPS = 2  # data-parallel steps on one fixed global batch, held against one process
DP_TRAINER_STEPS = 5
DP_COLLECTIVE_S = 120
DP_RANKS_S = 300
DP_LABEL = "grid_raw_tpu"
DP_DEVICE = "cuda:0"  # both ranks' device


def dp_scene(dev):
    from multimodalstudio_tpu_torch.configs.methods import FIVE_MODALITIES
    from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset

    kw = dict(raw=True, device=dev, **DISK_SCENE)
    views = DISK_SCENE["num_views"]
    return (make_synthetic_dataset(FIVE_MODALITIES, view_ids=[i for i in range(views) if i % 5 != 4],
                                   **kw),
            make_synthetic_dataset(FIVE_MODALITIES, view_ids=[i for i in range(views) if i % 5 == 4],
                                   **kw))


# phase E(a)'s gradients: one process's at the ranks' N (microbatches of 256 rays: the same
# sums in another order, and the L1 losses' signs where a residual's rounding moves with N)
# within DP_HALF_TOL (rel-L2) of one process's at 512; the ranks' within max(DP_GRAD_FLOOR,
# twice that distance) of one process's at 512
DP_HALF_TOL = 1e-2
DP_GRAD_FLOOR = 1e-5


def dp_grad_step(cfg) -> int:
    """The step of phase E(a)'s gradients: three quarters through the run, where every level
    of the slot grid is live (at step 0 its gradient is zero)."""
    return cfg.max_num_iterations * 3 // 4


def _grad_groups(grads):
    """One step's gradients (batch_loss_and_grads' fourth result) flattened by group on the
    host: each parameter group of _param_groups, and the camera poses."""
    out = {name: torch.cat([grads["fields"][k].reshape(-1).float().cpu() for k in keys])
           for name, keys in _param_groups(grads["fields"]).items()}
    out["camera_poses"] = torch.cat([g.reshape(-1).float().cpu()
                                     for _, g in sorted(grads["camera_poses"].items())])
    return out


def dp_reference(dev, work):
    """Phase E's inputs, saved to `work` for the ranks: grid_raw_tpu's seeded init with every
    MLP kernel moved off its geometric init (whose zero feature columns zero the slot table's
    gradient) and one global batch of 2048 rays per modality drawn on the card. Then the
    one-process reference on the card, without jitter: the gradients of that batch at
    dp_grad_step, with the configured 512-ray microbatches, with 256-ray ones (the ranks' N),
    and from rank 0's rows of each microbatch alone (the gradient of a reduction that drops
    rank 1's rows); and DP_STEPS steps on the batch. Returns a dict of those, on the host."""
    from multimodalstudio_tpu_torch.cameras.camera_optimizer import init_camera_poses
    from multimodalstudio_tpu_torch.configs.methods import FIVE_MODALITIES
    from multimodalstudio_tpu_torch.data.device_cache import build_device_cache, sample_pixel_batch
    from multimodalstudio_tpu_torch.engine import train as T
    from multimodalstudio_tpu_torch.models.model import MMSModel
    from multimodalstudio_tpu_torch.parallel.sharding import DataParallel, shard_batch

    cfg = load(DP_LABEL)
    train, _ = dp_scene(dev)
    cams = {m: train.data[m].cameras for m in FIVE_MODALITIES}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = MMSModel(cfg.model, device=dev).init(gen)
    with torch.no_grad():
        for k, p in model.named_parameters():
            if k.endswith("kernel"):
                p.add_(0.2 / p.shape[0] ** 0.5 * torch.randn(p.shape, generator=gen, device=dev))
    num_cameras = {m: train.num_frames(m) for m in FIVE_MODALITIES}
    poses = init_camera_poses(cfg.datamanager.camera_optimizer, FIVE_MODALITIES, num_cameras,
                              device=dev)
    batch = sample_pixel_batch(build_device_cache(train, device=dev), gen,
                               cfg.datamanager.num_rays_per_modality, FIVE_MODALITIES)
    torch.save({"model": {k: v.cpu() for k, v in model.state_dict().items()},
                "poses": {m: p.detach().cpu() for m, p in poses.items()},
                "batch": {m: {f.name: getattr(b, f.name).cpu() for f in dataclasses.fields(b)}
                          for m, b in batch.items()}}, os.path.join(work, "inputs.pt"))
    state = T.init_train_state(cfg, model, poses)
    at = dp_grad_step(cfg)
    sched = T.make_schedules(cfg, at)
    dm = cfg.datamanager
    rp = dataclasses.replace

    def grads(config, rays):
        return _grad_groups(T.batch_loss_and_grads(config, model, cams, state.camera_poses, rays,
                                                   at, sched)[3])

    micro = dm.microbatch_rays
    rows0 = [shard_batch(T._slice(batch, i * micro, (i + 1) * micro), DataParallel(0, DP_RANKS))
             for i in range(dm.num_rays_per_modality // micro)]
    rows0 = {m: type(batch[m])(*(torch.cat([getattr(r[m], f.name) for r in rows0])
                                 for f in dataclasses.fields(batch[m]))) for m in batch}
    ref = {"grads": grads(cfg, batch),
           "half": grads(rp(cfg, datamanager=rp(dm, microbatch_rays=micro // DP_RANKS)), batch),
           "rank0_rows": grads(rp(cfg, datamanager=rp(
               dm, num_rays_per_modality=dm.num_rays_per_modality // DP_RANKS,
               microbatch_rays=micro // DP_RANKS)), rows0)}
    step_fn = T.make_train_step(cfg, model, cams)
    ref["losses"] = []
    for _ in range(DP_STEPS):
        state, aux = step_fn(state, batch)
        ref["losses"].append(float(aux["losses"]["total_loss"]))
    ref["params"] = {k: p.detach().cpu() for k, p in model.named_parameters()}
    ref["poses"] = {m: p.detach().cpu() for m, p in state.camera_poses.items()}
    return ref


def dp_rank_main(work) -> None:
    """One rank of phase E (`chip_smoke.py --dp-rank <work>`, the process group's environment
    set by run_ranks): (a) the data-parallel gradients of the saved global batch, then DP_STEPS
    data-parallel steps on it, jitter off; (b) the dry run's Trainer
    (scripts/dist_dryrun_worker.py::train) at n_devices = DP_RANKS for DP_TRAINER_STEPS steps,
    jitter on. Both on cuda:0 over gloo, with the libraries the parent built (none is built
    here)."""
    import torch.distributed as dist

    from multimodalstudio_tpu_torch.configs.methods import FIVE_MODALITIES
    from multimodalstudio_tpu_torch.data.sampler import PixelBatch
    from multimodalstudio_tpu_torch.device import set_reference_precision
    from multimodalstudio_tpu_torch.engine import train as T
    from multimodalstudio_tpu_torch.models.model import MMSModel
    from multimodalstudio_tpu_torch.ops.kernels import build
    from multimodalstudio_tpu_torch.parallel import sharding
    from multimodalstudio_tpu_torch.scripts import dist_dryrun_worker as worker
    from multimodalstudio_tpu_torch.utils.writer import ITER_TRAIN_TIME

    missing = [n for n in build.LIBRARIES if not build.library_path(n).exists()]
    if missing:
        fail(f"a rank found {missing} unbuilt: the ranks load the parent's libraries")
    set_reference_precision()
    if not sharding.initialize_distributed(backend="gloo", device=DP_DEVICE):
        fail("phase E's rank is not in a group of several processes")
    dev = sharding.bind_device(DP_DEVICE)
    rank = sharding.process_index()
    out = {}
    try:
        probe = torch.full((3,), float(rank + 1), device=dev)
        dist.all_reduce(probe)
        out["gloo_cuda"] = (str(probe.device), probe.cpu().tolist())

        cfg = load(DP_LABEL)
        train, evald = dp_scene(dev)
        cams = {m: train.data[m].cameras for m in FIVE_MODALITIES}
        inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=True)
        batch = {m: PixelBatch(**{k: v.to(dev) for k, v in b.items()})
                 for m, b in inp["batch"].items()}
        model = MMSModel(cfg.model, device=dev)
        model.load_state_dict(inp["model"])
        state = T.init_train_state(cfg, model, {m: p.to(dev) for m, p in inp["poses"].items()})
        dp = sharding.DataParallel.current()
        step_fn = T.make_train_step(cfg, model, cams, dp)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        at = dp_grad_step(cfg)
        grads = T.batch_loss_and_grads(cfg, model, cams, state.camera_poses, batch, at,
                                       T.make_schedules(cfg, at), None, dp)[3]
        losses = []
        for _ in range(DP_STEPS):
            state, aux = step_fn(state, batch)
            losses.append(float(aux["losses"]["total_loss"]))
        torch.cuda.synchronize()
        out["a"] = {"grads": _grad_groups(grads), "losses": losses,
                    "params": {k: p.detach().cpu() for k, p in model.named_parameters()},
                    "poses": {m: p.detach().cpu() for m, p in state.camera_poses.items()},
                    "launches": {n: i.launches for n, i in build.KERNELS.items()}}
        del model, state, step_fn, grads

        rp = dataclasses.replace
        tcfg = rp(cfg, n_devices=DP_RANKS, max_num_iterations=DP_TRAINER_STEPS,
                  steps_per_eval_batch=0, steps_per_eval_image=0, steps_per_eval_all_images=0,
                  steps_per_save=0, steps_per_export_mesh=0, steps_per_export_poses=0,
                  logging=rp(cfg.logging, steps_per_log=1, steps_per_flush_buffer=0,
                             local_writer=False, vis="none"))
        torch.cuda.synchronize()
        build.reset_launch_counts()
        trainer, saves = worker.train(os.path.join(work, "run"), dev, tcfg, (train, evald))
        torch.cuda.synchronize()
        tensors = dict(trainer.model.named_parameters())
        tensors.update({f"pose.{m}": p for m, p in trainer.state.camera_poses.items()})
        out["b"] = {"step": trainer.state.step, "saves": len(saves),
                    "loss": float(trainer.last_aux["losses"]["total_loss"]),
                    "params": {k: t.detach().cpu() for k, t in tensors.items()},
                    "step_s": list(trainer.writer.buffer.times[ITER_TRAIN_TIME]),
                    "launches": {n: i.launches for n, i in build.KERNELS.items()}}
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def nccl_all_reduce(dev) -> float:
    """Phase E(c): a world-1 NCCL group on the card (the default backend of a CUDA device)
    and one all-reduce; returns its ms."""
    import datetime

    import torch.distributed as dist

    from multimodalstudio_tpu_torch.scripts.dist_dryrun import free_port

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=DP_COLLECTIVE_S))
    try:
        x = torch.arange(1 << 20, device=dev, dtype=torch.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(x)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        if not torch.equal(x, torch.arange(1 << 20, device=dev, dtype=torch.float32)):
            fail("a world-1 NCCL all-reduce changed its tensor")
    finally:
        dist.destroy_process_group()
    return ms


def dp_rank_command(rank, work):
    return [sys.executable, os.path.abspath(__file__), "--dp-rank", work]


def run_data_parallel(dev, card, work):
    """Phase E: grid_raw_tpu at full width and the bench geometry (2048 rays per modality in
    4 microbatches of 512), DP_RANKS processes on cuda:0 over gloo. (a) On one global batch
    without jitter, against one process on the card: the all-reduced gradients, each group
    (and the camera poses) within rel-L2 max(DP_GRAD_FLOOR, twice the distance between one
    process's gradients at 256- and at 512-ray microbatches), that distance within
    DP_HALF_TOL, the limit below what rank 0's rows alone give (a reduction that drops rank
    1's; one left unscaled by 1 / world reads 1); then DP_STEPS data-parallel steps, the
    losses within rtol 2e-3 and every parameter within atol 1e-3 (tests/test_parallel.py's
    bounds, which two warm-up steps cannot fail alone); both ranks' gradients and parameters
    equal bit for bit, every rank launching K1, K2 and K3 (each at 256 rays a modality a
    microbatch); (b) the dry run's Trainer at n_devices = DP_RANKS through the environment
    contract for DP_TRAINER_STEPS steps with jitter: the ranks equal bit for bit, the
    checkpoint written by rank 0 alone, the global rays/s and step ms; (c) one all-reduce of a
    world-1 NCCL group. Returns (the ranks' launches, stats)."""
    from multimodalstudio_tpu_torch.scripts.dist_dryrun import run_ranks

    ref = dp_reference(dev, work)
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    procs = run_ranks(lambda rank: dp_rank_command(rank, work), DP_RANKS, DP_RANKS_S,
                      {"MMS_DIST_TIMEOUT": str(DP_COLLECTIVE_S)}, here)
    ranks_s = time.perf_counter() - t0
    for r, proc in enumerate(procs):
        if proc.returncode != 0:
            fail(f"phase E rank {r} exited {proc.returncode}:\n{proc.stdout[-6000:]}")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=True)
             for r in range(DP_RANKS)]
    print(f"  {DP_RANKS} ranks on cuda:0 over gloo in {ranks_s:.1f} s; gloo all-reduced a CUDA "
          f"tensor in place on {ranks[0]['gloo_cuda'][0]}: {ranks[0]['gloo_cuda'][1]}")
    if ranks[0]["gloo_cuda"][1] != [3.0, 3.0, 3.0]:
        fail(f"gloo's all-reduce of a CUDA tensor gave {ranks[0]['gloo_cuda']}")

    a0 = ranks[0]["a"]
    g_err, g_tol = {}, {}
    for name, want in ref["grads"].items():
        got, half = a0["grads"][name], ref["half"][name]
        split = rel_l2(half, want)
        g_err[name] = rel_l2(got, want)
        g_tol[name] = max(DP_GRAD_FLOOR, 2 * split)
        wrong = rel_l2(ref["rank0_rows"][name], want)
        print(f"  (a) gradient of {name}: {DP_RANKS} ranks vs one process rel_l2={g_err[name]:.3e} "
              f"(limit {g_tol[name]:.3e}), vs one process at 256-ray microbatches "
              f"{rel_l2(got, half):.3e}; one process at 256 vs 512: {split:.3e} (limit "
              f"{DP_HALF_TOL:g}); rank 0's rows alone would read {wrong:.3e}")
        if not (want.norm() > 0 and torch.isfinite(got).all()):
            fail(f"phase E(a): one process's gradient of {name} is zero or the ranks' not finite")
        if not (split <= DP_HALF_TOL and g_err[name] <= g_tol[name]):
            fail(f"phase E(a): the data-parallel gradient of {name} parts from one process's")
        if not wrong > g_tol[name]:
            fail(f"phase E(a): the limit of {name}'s gradient, {g_tol[name]:.3e}, would not see "
                 "a reduction that drops rank 1's rows")
    err = max(abs(x - y) / abs(y) for x, y in zip(a0["losses"], ref["losses"]))
    p_err = max(float((a0["params"][k] - v).abs().max()) for k, v in ref["params"].items())
    p_err = max(p_err, max(float((a0["poses"][m] - v).abs().max())
                           for m, v in ref["poses"].items()))
    print(f"  (a) {DP_STEPS} steps on one global batch: losses {a0['losses']} against one "
          f"process's {ref['losses']} (max rel {err:.3e}, limit 2e-3); parameters within "
          f"{p_err:.3e} (limit 1e-3)")
    if err > 2e-3 or p_err > 1e-3:
        fail("phase E(a): the data-parallel steps part from one process's")
    launches, stats = {}, {}
    for r, res in enumerate(ranks):
        for part in ("a", "b"):
            for n, c in res[part]["launches"].items():
                launches[n] = launches.get(n, 0) + c
        got = {k: res["a"]["launches"].get(k, 0) for k in K123}
        print(f"  rank {r} launched {got} in (a)")
        if not all(got.values()):
            fail(f"phase E(a): rank {r} did not launch each of {K123}")
        for part, key in (("a", "grads"), ("a", "params"), ("a", "poses"), ("b", "params")):
            same = all(torch.equal(v, ranks[0][part][key][k]) for k, v in res[part][key].items())
            if not same:
                fail(f"phase E({part}): rank {r}'s {key} differ from rank 0's")

    b0, b1 = ranks[0]["b"], ranks[1]["b"]
    files = sorted(os.listdir(os.path.join(work, "run", "checkpoints")))
    if (b0["saves"], b1["saves"]) != (1, 0) or files != [f"step-{DP_TRAINER_STEPS:09d}.pt"]:
        fail(f"phase E(b): saves by rank {(b0['saves'], b1['saves'])}, checkpoints {files}")
    if b0["step"] != b1["step"] or b0["loss"] != b1["loss"] or not np.isfinite(b0["loss"]):
        fail(f"phase E(b): the ranks end at steps {b0['step']}, {b1['step']}, losses "
             f"{b0['loss']}, {b1['loss']}")
    step_ms = 1e3 * float(np.median(b0["step_s"][1:]))
    n_rays = load(DP_LABEL).datamanager.num_rays_per_modality * 5
    stats = dict(rays_per_s=n_rays / (step_ms / 1e3), step_ms=step_ms, ranks_s=ranks_s,
                 loss_err=err, param_err=p_err, first_step_ms=1e3 * b0["step_s"][0],
                 grad_err=g_err, grad_tol=g_tol)
    print(f"  (b) Trainer at n_devices={DP_RANKS}: {DP_TRAINER_STEPS} steps, the ranks equal bit "
          f"for bit, checkpoint {files} by rank 0 alone; global {stats['rays_per_s']:.1f} rays/s, "
          f"step {step_ms:.2f} ms (median of steps 2-{DP_TRAINER_STEPS}; first "
          f"{stats['first_step_ms']:.1f} ms; two ranks share one card: no gain; {card})")
    stats["nccl_ms"] = nccl_all_reduce(dev)
    print(f"  (c) a world-1 NCCL group on {dev}: one all-reduce of "
          f"4 MiB in {stats['nccl_ms']:.2f} ms (host clock, first call)")
    return launches, stats


# Phase F: the entry scripts of profiling and quality. Each profile: profile_step's environment,
# the PER_MICROBATCH label whose launches its steps make, and its microbatches a step.
PROFILES = {
    "default (mlp_raw_tpu, 2048 rays, 1024-ray microbatches)": ({}, "mlp_raw_tpu", 2),
    "grid_raw_tpu on capacity_base6's f32 table (BENCH_GRID_*), 512-ray microbatches": (
        {"PROF_METHOD": "grid_raw_tpu", "PROF_MICROBATCH": "512", "BENCH_GRID_FEATS": "16",
         "BENCH_GRID_ENTRIES": "512", "BENCH_GRID_DTYPE": "f32"},
        "grid_raw_tpu with f32 table", 4),
}
# the device kernels (csrc/*, by their names in a profile, template arguments dropped) and the
# wrappers whose launches run each of them once
DEVICE_KERNELS = {
    "k1_fwd_kernel": ("fused_chain",),
    "k1_pack_kernel": ("fused_chain_pack",),
    "k1_bwd_kernel": ("fused_chain_bwd",),
    "k1_wgrad_kernel": ("chain_wgrad", "fused_sdf_chain_wgrad", "fused_slot_sdf_value_wgrad",
                        "fused_slot_sdf_chain_wgrad"),
    "adj_fwd_kernel": ("fused_sdf_chain", "fused_slot_sdf_chain", "fused_slot_sdf_chain_f32"),
    "adj_bwd_pass_kernel": ("fused_sdf_chain_bwd",),
    "slot_value_kernel": ("fused_slot_sdf_value", "fused_slot_sdf_value_f32"),
    "slot_chain_pass_kernel": ("fused_slot_sdf_value_bwd", "fused_slot_sdf_value_f32_bwd",
                               "fused_slot_sdf_chain_bwd", "fused_slot_sdf_chain_f32_bwd"),
}
QUALITY_ARGS = ["--method", "grid_raw_tpu", "--modalities", "rgb", "mono"]
QUALITY_STEPS = 200
QUALITY_GAIN_DB = 3.0  # the least PSNR gain of each modality over the untrained state (PERF.md)


def device_kernel_counts(ops):
    """The profiled count of each DEVICE_KERNELS kernel, over its template instantiations."""
    import re

    return {k: sum(op["count"] for op in ops if re.search(rf"(^|[ :]){k}[<(]", op["name"]))
            for k in DEVICE_KERNELS}


def run_profiles(gen, dev, card):
    """scripts/profile_step.py on the card in each PROFILES environment (PROF_* and
    BENCH_GRID_* from nowhere else): its op_stats.json must exist, the profiled steps' device
    kernels come at PER_MICROBATCH's counts (per DEVICE_KERNELS), and its 6 steps' wrapper
    launches at those counts, every other kernel at 0. Each profile's first step holds every
    wrapper call it makes against the plain version (first_step_checked); before them, K4
    and K1's trunk are held, backwards included, at the default profile's N
    (check_profile_microbatch). Returns the launches, each profile's (busy ms, its top ops)
    and the max-abs errors by wrapper."""
    from multimodalstudio_tpu_torch.ops.kernels import build
    from multimodalstudio_tpu_torch.scripts import profile_step

    errs = check_profile_microbatch(gen, dev)
    launches, found = {}, {}
    for what, (env, label, microbatches) in PROFILES.items():
        print(f"  profile_step, {what}:")
        build.reset_launch_counts()
        t0 = time.perf_counter()
        with environment(env, cleared=("PROF_", "BENCH_GRID_")), \
                first_step_checked(f"profile_step ({what}), first step") as worst:
            trace_dir = profile_step.main(["--device", str(dev)])
        for n, e in worst.items():  # a slot wrapper on the f32 table launches K2f or K3f
            n += "_f32" if env.get("BENCH_GRID_DTYPE") == "f32" and "slot" in n else ""
            errs[n] = max(errs.get(n, 0.0), e)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {n: info.launches for n, info in build.KERNELS.items()}
        for n, c in counts.items():
            launches[n] = launches.get(n, 0) + c
        path = os.path.join(trace_dir, "op_stats.json")
        if not os.path.isfile(path):
            fail(f"profile_step wrote no {path}")
        with open(path) as f:
            stats = json.load(f)
        per = PER_MICROBATCH[label]
        steps = profile_step.WARMUP_STEPS + profile_step.PROFILED_STEPS
        want = {n: per.get(n, 0) * microbatches * steps for n in build.KERNELS}
        wrong = {n: (counts[n], want[n]) for n in want if counts[n] != want[n]}
        if wrong or stats["launches"] != {n: c for n, c in counts.items() if c}:
            fail(f"profile_step ({what}): launches (counted, expected) {wrong}, op_stats "
                 f"{stats['launches']}")
        ops = device_kernel_counts(stats["ops"])
        device = {k: (ops[k], sum(per.get(n, 0) for n in names) * microbatches * stats["steps"])
                  for k, names in DEVICE_KERNELS.items()}
        print(f"    {seconds:.1f} s; {stats['device']} busy {stats['busy_ms']:.3f} ms over "
              f"{stats['steps']} profiled steps ({card}); device kernels (profiled, expected): "
              + ", ".join(f"{k} {a}/{b}" for k, (a, b) in device.items() if a or b))
        bad = {k: v for k, v in device.items() if v[0] != v[1]}
        if bad:
            fail(f"profile_step ({what}): device kernels (profiled, expected) {bad}")
        found[what] = (stats["busy_ms"], stats["ops"][:12])
    return launches, found, errs


def run_quality(dev, card):
    """scripts/quality_check.py on the card: QUALITY_ARGS untrained (--steps 0) and after
    QUALITY_STEPS steps; every metric finite, K1-K3 launched (their backwards in training),
    each modality's PSNR QUALITY_GAIN_DB over its untrained figure. Returns the launches and
    both reports."""
    from multimodalstudio_tpu_torch.ops.kernels import build
    from multimodalstudio_tpu_torch.scripts import quality_check

    launches, reports = {}, {}
    for steps in (0, QUALITY_STEPS):
        print(f"  quality_check {' '.join(QUALITY_ARGS)} --steps {steps}:")
        build.reset_launch_counts()
        t0 = time.perf_counter()
        reports[steps] = quality_check.main(QUALITY_ARGS + ["--steps", str(steps)])
        torch.cuda.synchronize()
        counts = {n: info.launches for n, info in build.KERNELS.items()}
        for n, c in counts.items():
            launches[n] = launches.get(n, 0) + c
        print(f"    {time.perf_counter() - t0:.1f} s with its set-up ({card}); launches "
              + ", ".join(f"{n} {c}" for n, c in counts.items() if c))
        metrics = reports[steps]["metrics"]
        if not metrics or not all(np.isfinite(v) for m in metrics.values() for v in m.values()):
            fail(f"quality_check --steps {steps}: metrics {metrics}")
        need = ["fused_chain", "fused_slot_sdf_value", "fused_slot_sdf_chain"]
        if steps:
            need += ["fused_chain_bwd", "fused_slot_sdf_value_bwd", "fused_slot_sdf_chain_bwd"]
        if not all(counts[n] for n in need):
            fail(f"quality_check --steps {steps} did not launch every one of {need}")
    gains = {m: reports[QUALITY_STEPS]["metrics"][m]["psnr"] - reports[0]["metrics"][m]["psnr"]
             for m in reports[0]["metrics"]}
    print("  PSNR gain over the untrained state: " + ", ".join(
        f"{m} {g:+.3f} dB" for m, g in gains.items()) + f" (at least {QUALITY_GAIN_DB} dB)")
    if min(gains.values()) < QUALITY_GAIN_DB:
        fail(f"quality_check: PSNR gains {gains} under {QUALITY_GAIN_DB} dB")
    return launches, reports


def run_trained(dev, card):
    """Phases A-C; returns the launches of their runs, summed, and the rehearsal renders'
    rays/s and max-abs errors against the plain versions by wrapper."""
    import tempfile

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    launches, rays, errs = {}, {}, {}

    def add(counts, e):
        for n, c in counts.items():
            launches[n] = launches.get(n, 0) + c
        for n, v in e.items():
            errs[n] = max(errs.get(n, 0.0), v)

    datasets = phase("rehearsal scene", rehearsal_scene, dev)
    for name in REHEARSAL_LABELS:
        print(f"trained checkpoint {name} (RawEvaluator, rendering_scale 1.0):")
        counts, rays[name], _, e = phase(f"checkpoint {name}", run_checkpoint, dev, card, name,
                                         datasets)
        add(counts, e)
    print("mesh of rehearsal_grid_dense (export_mesh at 256^3):")
    add(*phase("mesh", run_mesh, dev, card, "rehearsal_grid_dense", datasets))
    print(f"entry points: launcher and Trainer on grid_raw_tpu, {ENTRY_SCENE}:")
    with tempfile.TemporaryDirectory() as root:
        add(phase("entry points", run_entry_points, dev, card, root), {})
    return launches, rays, errs


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    from multimodalstudio_tpu_torch.device import set_reference_precision
    from multimodalstudio_tpu_torch.ops.kernels import build
    from multimodalstudio_tpu_torch.ops.kernels.slot_grid import SlotGridSpec

    t_start = time.perf_counter()
    set_reference_precision()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}")
    print(f"built kernels in {build.build_all():.1f} s")

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gspec = SlotGridSpec(num_levels=6, min_res=16, max_res=512, rows_per_level=4096,
                         layout="cell", feats=2, table_dtype="bf16")
    print("kernel checks (forward: per 1024-ray eval chunk; backward: per 512-ray training "
          "microbatch):")
    results = phase("kernel checks", lambda: {
        "fused_chain": check_fused_chain(gen, dev),
        "fused_slot_sdf_value": check_slot_value(gen, dev, gspec),
        "fused_slot_sdf_chain": check_slot_chain(gen, dev, gspec),
        "fused_chain_bwd": check_fused_chain_bwd(gen, dev),
        "fused_slot_sdf_value_bwd": check_slot_value_bwd(gen, dev, gspec),
        "fused_slot_sdf_chain_bwd": check_slot_chain_bwd(gen, dev, gspec),
        "fused_sdf_chain": check_sdf_chain(gen, dev),
        "fused_sdf_chain_bwd": check_sdf_chain_bwd(gen, dev),
    })
    # K1's backward parts (the pack, chain_wgrad) timed inside its check, and K4's stacked gW
    results.update(results["fused_chain_bwd"].pop("parts"))
    results["fused_sdf_chain_wgrad"] = results["fused_sdf_chain_bwd"].pop("wgrad")
    results["fused_slot_sdf_chain_wgrad"] = results["fused_slot_sdf_chain_bwd"].pop("wgrad")
    results["fused_slot_sdf_value_wgrad"] = results["fused_slot_sdf_value_bwd"].pop("wgrad")
    # the training forwards' errors
    for name in ("fused_slot_sdf_value", "fused_slot_sdf_chain", "fused_sdf_chain"):
        results[name]["err"] = max(results[name]["err"], results[name + "_bwd"].pop("fwd_err"))
    print("kernel checks at the mlp_raw_tpu chains of K1:")
    phase("K1 at mlp_raw_tpu widths", check_mlp_chains, gen, dev)
    print("kernel checks of K6 and K5 (grid_raw_tpu without PE; forward: per 1024-ray eval "
          "chunk; backward: per 512-ray training microbatch):")
    results.update(phase("K6 and K5", lambda: {
        "slot_grid_lookup": check_slot_grid_lookup(gen, dev, gspec),
        "slot_grid_lookup_bwd": check_slot_grid_lookup_bwd(gen, dev, gspec),
        "fused_chain_adjoint": check_chain_adjoint(gen, dev),
        "fused_chain_adjoint_bwd": check_chain_adjoint_bwd(gen, dev),
    }))
    results["fused_chain_adjoint_wgrad"] = results["fused_chain_adjoint_bwd"].pop("wgrad")
    print("kernel checks off the main paths' shapes:")
    phase("edge cases", lambda: (check_edge_cases(gen, dev, gspec), check_sdf_chain_edges(gen, dev),
                                 check_nope_edges(gen, dev, gspec)))
    # the tangent phases draw from `gen` last: the earlier phases' inputs do not depend on them
    print("kernel checks of K1t and K4j (mlp_raw_tpu with contraction and in jvp mode; forward: "
          "per 1024-ray eval chunk; backward: per 512-ray training microbatch):")
    results.update(phase("K1t and K4j", lambda: {
        "fused_chain_tangents": check_chain_tangents(gen, dev),
        "fused_chain_tangents_bwd": check_chain_tangents_bwd(gen, dev),
        "fused_sdf_chain_jvp": check_sdf_chain_jvp(gen, dev),
        "fused_sdf_chain_jvp_bwd": check_sdf_chain_jvp_bwd(gen, dev),
    }))
    for name in ("fused_chain_tangents", "fused_sdf_chain_jvp"):
        results[name + "_wgrad"] = results[name + "_bwd"].pop("wgrad")
    print("kernel checks of K1t and K4j off the main paths' shapes:")
    phase("K1t and K4j edge cases", check_tangent_edges, gen, dev)
    # the split phases draw from `gen` after every earlier phase
    print("kernel checks of K2s, K3s and the table scatter (grid_raw_tpu with split backward; "
          "per 512-ray training microbatch):")
    split = phase("K2s, K3s and the scatter", lambda: (check_slot_value_split(gen, dev, gspec),
                                                       check_slot_chain_split(gen, dev, gspec)))
    for name, r in zip(("fused_slot_sdf_value", "fused_slot_sdf_chain"), split):
        results[name]["err"] = max(results[name]["err"], r["fwd_err"])
    results.update(split_results(*split))
    print("kernel checks deeper than the registered methods (10 layers; 9 and 16 grid levels):")
    phase("depth edge cases", check_depth_edges, gen, dev)
    # the f32 table's phases draw from `gen` after every earlier phase
    f32spec = f32_spec()
    print("kernel checks of K2f and K3f (grid_raw_tpu with f32 table; forward: per 1024-ray eval "
          "chunk; backward: per 512-ray training microbatch):")
    f32 = phase("K2f and K3f", lambda: {
        "fused_slot_sdf_value_f32": check_slot_value(gen, dev, f32spec),
        "fused_slot_sdf_chain_f32": check_slot_chain(gen, dev, f32spec),
        "fused_slot_sdf_value_f32_bwd": check_slot_value_bwd(gen, dev, f32spec),
        "fused_slot_sdf_chain_f32_bwd": check_slot_chain_bwd(gen, dev, f32spec),
    })
    for name in ("fused_slot_sdf_value_f32", "fused_slot_sdf_chain_f32"):
        f32[name]["err"] = max(f32[name]["err"], f32[name + "_bwd"].pop("fwd_err"))
    for name in ("chain", "value"):
        wg = results[f"fused_slot_sdf_{name}_wgrad"]
        wg["err"] = max(wg["err"], f32[f"fused_slot_sdf_{name}_f32_bwd"].pop("wgrad")["err"])
    results.update(f32)
    print("kernel checks of K2fs, K3fs and the f32 table scatter (grid_raw_tpu with f32 table and "
          "split backward; per 512-ray training microbatch):")
    split = phase("K2fs, K3fs and the f32 scatter", lambda: (
        check_slot_value_split(gen, dev, f32spec), check_slot_chain_split(gen, dev, f32spec)))
    for name, r in zip(("fused_slot_sdf_value_f32", "fused_slot_sdf_chain_f32"), split):
        results[name]["err"] = max(results[name]["err"], r["fwd_err"])
    results.update(split_results(*split, f32=True))
    print("kernel checks with a skip connection (bf16 and f32 tables; 10 layers with scratch "
          "stacks):")
    phase("skip edge cases", check_skip_edges, gen, dev, (gspec, f32spec))
    # the lookup's exact-f32 phases draw from `gen` after every earlier phase
    print("kernel checks of K6 with an f32 cell table (grid_raw_tpu with f32 table's grid; "
          "forward: one microbatch's render samples and sampler queries; backward: per 512-ray "
          "training microbatch):")
    phase("K6 with an f32 table", lambda: (check_slot_grid_lookup(gen, dev, f32spec, timed=False),
                                           check_slot_grid_lookup_bwd(gen, dev, f32spec,
                                                                      timed=False)))
    vspec = vertex_spec()
    print("kernel checks of K6v (grid_raw_tpu without PE, vertex layout; forward: per 1024-ray "
          "eval chunk; backward: per 512-ray training microbatch):")
    results.update(phase("K6v", lambda: {
        "slot_grid_lookup_vertex": check_slot_grid_lookup(gen, dev, vspec),
        "slot_grid_lookup_vertex_bwd": check_slot_grid_lookup_bwd(gen, dev, vspec),
    }))
    print("kernel checks of K6v off the main path's shapes:")
    phase("K6v edge cases", check_lookup_edges, gen, dev, vspec)
    # the vertex label's SDF head (99 inputs) draws from `gen` after every earlier phase
    print("kernel checks of K5 and K1 on the SDF head of grid_raw_tpu without PE, vertex layout "
          "(99 -> 128 -> 128 -> 257; forward: per 1024-ray eval chunk; backward: per 512-ray "
          "training microbatch):")
    wide = phase("K5 and K1 at 99 inputs", lambda: {
        "fused_chain_adjoint": check_chain_adjoint(gen, dev, VERTEX_DIMS, "K5 at 99 inputs"),
        "fused_chain_adjoint_bwd": check_chain_adjoint_bwd(gen, dev, VERTEX_DIMS,
                                                           "K5 at 99 inputs", conditioned=True),
        **dict(zip(("fused_chain", "fused_chain_bwd"), check_sdf_head(gen, dev))),
    })
    wide["fused_chain_adjoint_wgrad"] = wide["fused_chain_adjoint_bwd"].pop("wgrad")
    for name, r in wide.items():
        results[name]["err"] = max(results[name]["err"], r["err"])
        print_timing(f"{name} at 99 inputs ({card})", r)
    # hidden widths 384 and 512 draw from `gen` after every earlier phase
    print("kernel checks at hidden widths 384 and 512 (K1 forward and backward; K4, K5, K1t and "
          "K4j forwards and backwards):")
    phase("hidden widths 384 and 512", check_wide_hidden, gen, dev)
    # hidden widths past 512 draw from `gen` after every earlier phase
    print("kernel checks at hidden widths 640, 768 and 1024 (K1 forward and backward; K4, K5, K1t "
          "and K4j forwards and backwards; K2/K2f and K3/K3f forwards and backwards, merged and "
          "split; every forward and backward bit for bit against the 512-wide kernels on padded "
          "chains):")
    phase("hidden widths 640, 768 and 1024", check_wide_hidden, gen, dev, (640, 768, 1024))
    # the ray-ordered K6v draws from `gen` after every earlier phase
    print("kernel checks of K6v at ray-ordered positions (grid_raw_tpu without PE, vertex "
          "layout; per 512-ray training microbatch):")
    ray = phase("K6v at ray-ordered positions", check_lookup_ray_order, gen, dev, vspec)
    for name, r in zip(("slot_grid_lookup_vertex",) + ("slot_grid_lookup_vertex_bwd",) * 2, ray):
        results[name]["err"] = max(results[name]["err"], r["err"])
    # the ray-ordered K6 and scatters draw from `gen` after every earlier phase
    print("kernel checks of K6 at ray-ordered positions (grid_raw_tpu without PE; per 512-ray "
          "training microbatch):")
    ray = phase("K6 at ray-ordered positions", check_lookup_ray_order, gen, dev, gspec)
    for name, r in zip(("slot_grid_lookup",) + ("slot_grid_lookup_bwd",) * 2, ray):
        results[name]["err"] = max(results[name]["err"], r["err"])
    print("kernel checks of the table scatters at ray-ordered positions (grid_raw_tpu with split "
          "backward, bf16 and f32 tables; per 512-ray training microbatch):")
    for name, spec in (("slot_table_scatter", gspec), ("slot_table_scatter_f32", f32spec)):
        r = phase(f"{name} at ray-ordered positions", check_scatter_ray_order, gen, dev, spec)
        results[name]["err"] = max(results[name]["err"], r["err"])
    rays_per_s, train, launches = {}, {}, {}

    def add(counts):  # each run counts from 0
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count

    def run_label(method):
        with config_env(method):
            if method in SAME_RENDER:
                print(f"render ({method}): that of {SAME_RENDER[method]}")
                rays_per_s[method] = rays_per_s[SAME_RENDER[method]]
            else:
                print(f"render ({method}):")
                _, rays_per_s[method] = phase(f"render {method}", run_slice, dev, card, method)
            print(f"training ({method}):")
            train[method] = phase(f"training {method}", run_training, dev, card, method)
        add(train[method]["launches"])

    for method in CONFIGS:
        if method != VOLSDF_LABEL:
            run_label(method)
    # phases A-C: the trained checkpoints, the mesh and the entry points
    trained, rehearsal_rays, _ = phase("trained checkpoints and entry points", run_trained, dev,
                                       card)
    add(trained)
    # phase D: a scene from disk; then the labels that run last
    import tempfile

    print(f"scene from disk: {ENTRY_SCENE} written and loaded, launcher on the directory:")
    with tempfile.TemporaryDirectory() as root:
        disk_launches, disk = phase("scene from disk", run_disk_scene, dev, card, root)
    add(disk_launches)
    run_label(VOLSDF_LABEL)
    # phase E: data parallel over two processes on the card
    print(f"data parallel ({DP_LABEL}, {DP_RANKS} processes on cuda:0 over gloo):")
    with tempfile.TemporaryDirectory() as root:
        dp_launches, dp = phase("data parallel", run_data_parallel, dev, card, root)
    add(dp_launches)
    # phase F: the entry scripts, the step profiler and the quality harness
    print("entry scripts: profile_step and quality_check on the card:")
    prof_launches, profiles, prof_errs = phase("step profiles", run_profiles, gen, dev, card)
    add(prof_launches)
    for name, e in prof_errs.items():
        results[name]["err"] = max(results[name]["err"], e)
    qc_launches, quality = phase("quality harness", run_quality, dev, card)
    add(qc_launches)

    entries = []
    for name, r in results.items():
        info = build.KERNELS[name]
        b_ms, b_by = bound(r["flops"], r["bytes"], r.get("peak", H100_BF16_FLOPS))
        entries.append({
            "name": name, "route": "cuda", "source": info.source, "replaces": info.replaces,
            "launches": launches[name], "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": r.get("library_ms"),
            **({"kernel_ms": r["kernel_ms"], "device_ops": r["ops"]} if "ops" in r else {}),
            **({"standalone_ms": r["standalone_ms"]} if "standalone_ms" in r else {}),
        })
    for method in rays_per_s:
        t = train[method]
        share = 100 * t.get("index_ms", 0.0) / t["busy_ms"]
        index = f", index_select's and index_add_'s kernels {share:.1f}% of it" if share else ""
        print(f"{method}: eval rays/s {rays_per_s[method]:.1f}, train rays/s {t['rays_per_s']:.1f}, "
              f"step {t['step_ms']:.2f} ms, card busy {100 * t['busy']:.1f}% of a step, peak "
              f"memory {t['peak_gib']:.2f} GiB{index} ({card})")
    for name, r in rehearsal_rays.items():
        print(f"{name}: eval rays/s {r:.1f} at rendering_scale 1.0 ({card})")
    print(f"scene from disk: load {disk['load_s']:.3f} s for {disk['frames']} frames "
          f"({1e3 * disk['load_s'] / disk['frames']:.2f} ms a frame, host), a {CAPTURE_FRAME}² "
          f"16-bit frame's decode {disk['decode_ms']['sub']:.1f} ms (Sub rows) and "
          f"{disk['decode_ms']['mixed']:.1f} ms (mixed rows), launcher train "
          f"{disk['launcher_rays_per_s']:.1f} rays/s and eval {disk['eval_rays_per_s']:.1f} rays/s "
          f"with their set-up, bench-geometry train rays/s {disk['rays_per_s']:.1f}, step "
          f"{disk['step_ms']:.2f} ms, busy {disk['busy_ms']:.2f} ms a step; host sampler "
          f"{disk['sampler_ms']['native']:.3f} ms native, {disk['sampler_ms']['numpy']:.3f} ms numpy "
          f"a {SAMPLER_RAYS}-ray x 5-modality batch; LPIPS card/CPU rel {disk['lpips'][2]:.3e} "
          f"({card})")
    print(f"data parallel: {DP_RANKS} ranks on one card, global train rays/s "
          f"{dp['rays_per_s']:.1f}, step {dp['step_ms']:.2f} ms, {DP_STEPS} steps within "
          f"{dp['loss_err']:.3e} (loss) and {dp['param_err']:.3e} (parameters) of one process, "
          f"NCCL world-1 all-reduce {dp['nccl_ms']:.2f} ms ({card})")
    for what, (busy_ms, top) in profiles.items():
        print(f"profile_step, {what}: busy {busy_ms:.3f} ms over 3 steps; top ops " + "; ".join(
            f"{op['name'][:60]} {op['self_ms']:.3f} ms {op['count']}x" for op in top[:5])
            + f" ({card})")
    q0, q1 = quality[0], quality[QUALITY_STEPS]
    print(f"quality_check: {q1['rays_per_sec']} train rays/s over {QUALITY_STEPS} steps; PSNR "
          + ", ".join(f"{m} {q0['metrics'][m]['psnr']:.3f} -> {q1['metrics'][m]['psnr']:.3f} dB"
                      for m in q1["metrics"]) + f" ({card})")
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s ({card})")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--dp-rank":
        dp_rank_main(sys.argv[2])
    else:
        main()
