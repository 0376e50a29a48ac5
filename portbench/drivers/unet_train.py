"""Driver of the U-Net's training step: the port's ``make_train_step`` on
``create_unet`` at the configuration's widths and pooling (bfloat16
convolutions).

Set-up makes a pool of crops on the device from the seed (the fused
cell's Voronoi recipe; the input standardized per crop, the targets the
12 affinities of the crops' cell labels), the weights on the device from
the seed, one train state, and the step.  The step's first three calls,
on three batches whose crops all differ, are its warm-up and the steps
the reference follows.  The window keeps calling the same step on the same
state, each batch 8 distinct crops of the pool in an order drawn from the
seed, until ``--seconds`` have passed, and ends in a synchronize;
``train_mvox_per_s`` is the batch voxels of every step over that time.
The traced run profiles ``trace_steps`` steps.

After the window the program's losses of steps 1-3, its first gradient
(read from AdamW's first moment after step 1) and its parameters before
step 4 are compared with the plain float32 reference's three steps from
the same weights on the same batches.

``controls`` gives the readings that the limits were set from: the
program's, the control's (the reference with float8 e4m3 convolutions in
the program's place) and those of two planted faults (the step fed half
of each batch; the step returning the state it was given).
"""

from __future__ import annotations

import math
import os
import sys
import time
import traceback

import numpy as np


def affinities(lab, offsets):
    """(C, D, H, W) float32: 1 where a voxel and its offset neighbour lie
    in one cell, 0 across cells or outside the crop."""
    import torch

    out = torch.zeros((len(offsets),) + tuple(lab.shape),
                      dtype=torch.float32, device=lab.device)
    for c, off in enumerate(offsets):
        dst, src = [], []
        for o, s in zip(off, lab.shape):
            if o >= 0:
                dst.append(slice(0, s - o))
                src.append(slice(o, s))
            else:
                dst.append(slice(-o, s))
                src.append(slice(0, s + o))
        out[c][tuple(dst)] = (lab[tuple(dst)] == lab[tuple(src)]).float()
    return out


def make_pool(n, crop, offsets, seed, dev):
    import torch

    from portbench.refs import volume

    xs = torch.empty((n, 1) + tuple(crop), dtype=torch.float32, device=dev)
    ys = torch.empty((n, len(offsets)) + tuple(crop), dtype=torch.float32,
                     device=dev)
    for i in range(n):
        lab, bnd = volume.synthetic_volume(crop, seed * 1000003 + i, dev)
        raw = bnd.float()
        xs[i, 0] = (raw - raw.mean()) / raw.std(correction=0)
        ys[i] = affinities(lab, offsets)
    return xs, ys


def architecture(cfg):
    """(features, pooling factors) of the configuration, as tuples."""
    return (tuple(int(f) for f in cfg["features"]),
            tuple(tuple(int(v) for v in s) for s in cfg["scale_factors"]))


def make_model(cfg, dev):
    """``create_unet`` at the configuration's widths and pooling."""
    from cluster_tools_tpu_torch.models.unet import create_unet

    features, scales = architecture(cfg)
    model = create_unet(out_channels=cfg["out_channels"], features=features,
                        anisotropic=scales[0] == (1, 2, 2)).to(dev)
    if model.scale_factors != scales:
        raise RuntimeError(f"create_unet pools {model.scale_factors}, the "
                           f"configuration {scales}")
    return model


def make_weights(seed, dev, cfg):
    """The U-Net's parameters from the seed, on the device, in one draw:
    kernels LeCun-normal truncated at +-2 standard deviations, biases 0,
    GroupNorm scales 1."""
    import torch

    from portbench.refs.unet import param_shapes

    shapes = param_shapes(*architecture(cfg), cfg["in_channels"],
                          cfg["out_channels"])
    kernels = [k for k in shapes if k.endswith("weight")
               and len(shapes[k]) == 5]
    total = sum(math.prod(shapes[k]) for k in kernels)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    flat = torch.empty(total, device=dev)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, pos = {}, 0
    for k, s in shapes.items():
        if k in kernels:
            n = math.prod(s)
            # fan in: input channels x kernel volume (a transposed
            # convolution's weight is (in, out, k...))
            c_in = s[0] if k.startswith("upsamplers") else s[1]
            fan_in = c_in * math.prod(s[2:])
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            out[k] = flat[pos:pos + n].reshape(s) * std
            pos += n
        elif "norms" in k and k.endswith("weight"):
            out[k] = torch.ones(s, device=dev)
        else:
            out[k] = torch.zeros(s, device=dev)
    return out


def run(ctx):
    import torch

    t_start = time.perf_counter()
    from cluster_tools_tpu_torch.models import train as T

    from portbench.reduce import written_bytes
    from portbench.refs import unet as R

    cfg, tr, dev = ctx.config, ctx.workload["traffic"], ctx.device
    B, crop, n_pool = int(tr["batch"]), tuple(tr["crop"]), int(tr["pool"])
    offsets = [tuple(o) for o in cfg["offsets"]]
    split = {"cpu_count": os.cpu_count()}
    io0 = written_bytes()
    t = time.perf_counter()
    xs, ys = make_pool(n_pool, crop, offsets, ctx.seed, dev)
    p0 = make_weights(ctx.seed, dev, cfg)
    split["data_s"] = time.perf_counter() - t

    rng = np.random.default_rng(ctx.seed)
    first = rng.permutation(n_pool)[:3 * B].reshape(3, B)
    later = np.stack([rng.permutation(n_pool)[:B]
                      for _ in range(int(tr["max_steps"]))])
    order = torch.from_numpy(np.concatenate([first, later])).to(dev)

    t = time.perf_counter()
    model = make_model(cfg, dev)
    if set(model.state_dict()) != set(p0):
        raise RuntimeError("the port's U-Net has other parameters than the "
                           "reference's")
    opt = T.make_optimizer(cfg["optimizer"]["lr"],
                           cfg["optimizer"]["weight_decay"])
    params = {k: p0[k].clone() for k in model.state_dict()}
    state = T.TrainState(params, opt.init(params), 0,
                         config=T.model_config(model),
                         optimizer=opt.config())
    step = T.make_train_step(model)

    def batch(i):
        idx = order[i]
        return xs.index_select(0, idx), ys.index_select(0, idx)

    losses, g1 = [], None
    for i in range(3):
        state, loss = step(state, *batch(i))
        losses.append(float(loss))
        if i == 0:
            g1 = {k: v.detach().clone() / (1.0 - T.AdamW.B1)
                  for k, v in state.opt_state.mu.items()}
    p3 = {k: v.detach().clone() for k, v in state.params.items()}
    if dev == "cuda":
        torch.cuda.synchronize()
    split["steps_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    trace, failed, n_steps, elapsed = None, 0, 0, 0.0
    try:
        if ctx.trace:
            trace = _traced(ctx, step, state, batch, B, crop)
        else:
            t0 = time.perf_counter()
            i = 3
            while time.perf_counter() - t0 < ctx.seconds and \
                    i < order.shape[0]:
                state, loss = step(state, *batch(i))
                i += 1
            if dev == "cuda":
                torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            n_steps = i - 3
    except Exception:  # a failed step fails the run, reported below
        traceback.print_exc(file=sys.stderr)
        failed = 1
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    del state, step, model
    if dev == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    batches = [batch(i) for i in range(3)]
    ref_losses, ref_g1, ref_p3 = R.train_steps(
        p0, batches, int(tr["micro_batch"]), architecture(cfg)[1])
    nums = R.compare(losses, g1, p0, p3, ref_losses, ref_g1, ref_p3)
    split["reference_s"] = time.perf_counter() - t
    split["written"] = {k: v - io0.get(k, 0)
                        for k, v in written_bytes().items()}
    metrics = {}
    if not ctx.trace and n_steps:
        metrics["train_mvox_per_s"] = n_steps * B * math.prod(crop) / \
            elapsed / 1e6
        metrics["setup_s"] = setup_s
        split["steps"] = n_steps
        split["window_s"] = elapsed
    if trace is not None:
        trace.info["peak_bytes"] = peak
        n_steps = trace.info["steps"]
    split["losses"] = losses
    split["ref_losses"] = ref_losses
    return {"attempted": n_steps + 3 + failed, "failed": failed,
            "metrics": metrics, "memory_peak_bytes": peak,
            "readings": nums, "trace": trace,
            "info": {"setup_split": split}}


def controls(ctx, seeds, n_controls):
    """Per seed, at the cell's own size: the program's three steps judged
    against the reference; for the first ``n_controls`` seeds also the
    control's (float8 e4m3 convolutions), those of the step fed half of
    each batch, and those of the step returning the state it was given.  Yields ``{"seed", "side", <reading>: value}``."""
    import torch

    from cluster_tools_tpu_torch.models import train as T

    from portbench.refs import unet as R

    cfg, tr, dev = ctx.config, ctx.workload["traffic"], ctx.device
    B, crop = int(tr["batch"]), tuple(tr["crop"])
    micro, scales = int(tr["micro_batch"]), architecture(cfg)[1]
    offsets = [tuple(o) for o in cfg["offsets"]]
    model = make_model(cfg, dev)
    opt = T.make_optimizer(cfg["optimizer"]["lr"],
                           cfg["optimizer"]["weight_decay"])
    step = T.make_train_step(model)

    def program(p0, batches, frozen=False):
        params = {k: p0[k].clone() for k in model.state_dict()}
        state = T.TrainState(params, opt.init(params), 0,
                             config=T.model_config(model),
                             optimizer=opt.config())
        losses, g1 = [], None
        for i, (x, y) in enumerate(batches):
            new, loss = step(state, x, y)
            state = state if frozen else new
            losses.append(float(loss))
            if i == 0:
                g1 = {k: v.clone() / (1.0 - T.AdamW.B1)
                      for k, v in state.opt_state.mu.items()}
        return losses, g1, {k: v.clone() for k, v in state.params.items()}

    for i, seed in enumerate(seeds):
        xs, ys = make_pool(int(tr["pool"]), crop, offsets, seed, dev)
        p0 = make_weights(seed, dev, cfg)
        first = np.random.default_rng(seed).permutation(
            int(tr["pool"]))[:3 * B].reshape(3, B)
        batches = [(xs[j], ys[j]) for j in
                   (torch.from_numpy(r).to(dev) for r in first)]
        prog = program(p0, batches)
        ref = R.train_steps(p0, batches, micro, scales)
        yield {"seed": seed, "side": "program",
               **R.compare(*prog[:2], p0, prog[2], *ref)}
        if i < n_controls:
            ctl = R.train_steps(p0, batches, micro, scales, fp8=True)
            yield {"seed": seed, "side": "control",
                   **R.compare(*ctl[:2], p0, ctl[2], *ref)}
            half = program(p0, [(x[:B // 2], y[:B // 2])
                                for x, y in batches])
            yield {"seed": seed, "side": "half_batch",
                   **R.compare(*half[:2], p0, half[2], *ref)}
            # every step returns the state it was given
            still = program(p0, batches, frozen=True)
            yield {"seed": seed, "side": "state_unchanged",
                   **R.compare(*still[:2], p0, still[2], *ref)}
        del xs, ys, batches
        if dev == "cuda":
            torch.cuda.empty_cache()


def _traced(ctx, step, state, batch, B, crop):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.refs.cost import unet_step_flop
    from portbench.reduce import Trace, device_ops, marker_offset

    n = int(ctx.workload["traffic"]["trace_steps"])
    acts = [ProfilerActivity.CPU]
    if ctx.device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        tp0 = time.perf_counter()
        with record_function("portbench.window"):
            for i in range(3, 3 + n):
                state, _ = step(state, *batch(i))
            if ctx.device == "cuda":
                torch.cuda.synchronize()
        tp1 = time.perf_counter()
    ops = device_ops(prof)
    w0 = marker_offset(prof, "portbench.window") or 0.0
    window = tp1 - tp0
    ops = [(nm, a - w0, b - w0) for nm, a, b in ops
           if b - w0 > 0 and a - w0 < window]
    return Trace(cell=ctx.workload, config=ctx.config, window_s=window,
                 device_ops=ops,
                 info={"steps": n, "step_flop": unet_step_flop(
                     B, crop, *architecture(ctx.config))})
