"""Driver of Swin UNETR's training step: the port's ``make_train_step`` on
``create_swin_unetr`` at the configuration's widths (bfloat16
convolutions, linears and attention products).

Set-up makes a pool of crops on the device from the seed (the U-Net
cell's ``make_pool``: Voronoi crops, standardized, with the 12 affinities
of their cell labels), the weights on the device from the seed, one train
state and the step.  The step's first three calls, on three batches whose
crops all differ, are its warm-up and the steps the reference follows.
The window keeps calling the step on batches of distinct crops of the pool
in an order drawn from the seed until ``--seconds`` have passed, and ends
in a synchronize; ``train_mvox_per_s`` is the batch voxels of every step
over that time.  The traced run profiles ``trace_steps`` steps with the
port's telemetry on.

After the window the program's losses of steps 1-3, its first gradient
(AdamW's first moment after step 1) and its parameters before step 4 are
compared with the plain float32 reference's three steps from the same
weights on the same batches (``refs/swin_unetr.py``).

``controls`` gives the readings that the limits were set from: the
program's, the control's (the reference with float8 e4m3 inputs to every
convolution, linear and attention product) and those of four planted
faults (no block shifts its windows; the relative-position bias left out;
the step fed half of each batch; the step returning the state it was
given).
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
import time
import traceback

import numpy as np


def _pool_driver():
    from portbench import run

    return run.load_driver("unet_train")


def make_model(cfg, dev):
    """``create_swin_unetr`` at the configuration's widths, computing in
    its ``compute_dtype``."""
    import torch

    from cluster_tools_tpu_torch.models.swin_unetr import create_swin_unetr

    return create_swin_unetr(
        in_channels=cfg["in_channels"], out_channels=cfg["out_channels"],
        feature_size=cfg["feature_size"], depths=tuple(cfg["depths"]),
        num_heads=tuple(cfg["num_heads"]), window_size=cfg["window_size"],
        dtype=getattr(torch, cfg["compute_dtype"])).to(dev)


def make_weights(seed, dev, cfg):
    """Swin UNETR's parameters from the seed, on the device, in one draw
    of normals truncated at +-2: convolution kernels scaled to variance
    1 / fan_in (LeCun), Linear weights and bias tables by 0.02, biases 0,
    LayerNorm scales 1."""
    import torch

    from portbench.refs.swin_unetr import param_shapes

    shapes = param_shapes(cfg)
    drawn = [k for k, s in shapes.items()
             if len(s) == 5 or (len(s) == 2 and k.endswith(
                 ("weight", "relative_position_bias_table")))]
    total = sum(math.prod(shapes[k]) for k in drawn)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    flat = torch.empty(total, device=dev)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, pos = {}, 0
    for k, s in shapes.items():
        if k in drawn:
            n = math.prod(s)
            if len(s) == 5:
                # a transposed convolution's weight is (in, out, k...)
                c_in = s[0] if ".up." in k else s[1]
                std = math.sqrt(1.0 / (c_in * math.prod(s[2:]))) \
                    / 0.87962566103423978
            else:
                std = 0.02
            out[k] = flat[pos:pos + n].reshape(s) * std
            pos += n
        elif k.endswith("weight"):
            out[k] = torch.ones(s, device=dev)
        else:
            out[k] = torch.zeros(s, device=dev)
    return out


def _setup(ctx):
    """(model, step, a fresh train state from given weights) of the
    cell."""
    from cluster_tools_tpu_torch.models import train as T

    cfg = ctx.config
    model = make_model(cfg, ctx.device)
    opt = T.make_optimizer(cfg["optimizer"]["lr"],
                           cfg["optimizer"]["weight_decay"])
    step = T.make_train_step(model, cfg["optimizer"]["lr"])

    def fresh(p0):
        params = {k: p0[k].clone() for k in model.state_dict()}
        return T.TrainState(params, opt.init(params), 0,
                            config=T.model_config(model),
                            optimizer=opt.config())

    return model, step, fresh


def _first_grad(state):
    from cluster_tools_tpu_torch.models import train as T

    return {k: v.detach().clone() / (1.0 - T.AdamW.B1)
            for k, v in state.opt_state.mu.items()}


def run(ctx):
    import torch

    t_start = time.perf_counter()
    from portbench.reduce import written_bytes
    from portbench.refs import swin_unetr as R

    cfg, tr, dev = ctx.config, ctx.workload["traffic"], ctx.device
    B, crop, n_pool = int(tr["batch"]), tuple(tr["crop"]), int(tr["pool"])
    offsets = [tuple(o) for o in cfg["offsets"]]
    split = {"cpu_count": os.cpu_count()}
    io0 = written_bytes()
    t = time.perf_counter()
    model, step, fresh = _setup(ctx)
    xs, ys = _pool_driver().make_pool(n_pool, crop, offsets, ctx.seed, dev)
    p0 = make_weights(ctx.seed, dev, cfg)
    split["data_s"] = time.perf_counter() - t

    rng = np.random.default_rng(ctx.seed)
    first = rng.permutation(n_pool)[:3 * B].reshape(3, B)
    later = np.stack([rng.permutation(n_pool)[:B]
                      for _ in range(int(tr["max_steps"]))])
    order = torch.from_numpy(np.concatenate([first, later])).to(dev)

    t = time.perf_counter()
    if set(model.state_dict()) != set(p0):
        raise RuntimeError("the port's Swin UNETR has other parameters than "
                           "the reference's")
    state = fresh(p0)

    def batch(i):
        idx = order[i]
        return xs.index_select(0, idx), ys.index_select(0, idx)

    losses, g1 = [], None
    for i in range(3):
        state, loss = step(state, *batch(i))
        losses.append(float(loss))
        if i == 0:
            g1 = _first_grad(state)
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
    ref_losses, ref_g1, ref_p3 = R.train_steps(p0, batches,
                                               int(tr["micro_batch"]), cfg)
    nums = R.swin_compare(losses, g1, p0, p3, ref_losses, ref_g1, ref_p3)
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


@contextlib.contextmanager
def planted(fault: str):
    """The port's Swin UNETR with a fault planted while the context is
    open: ``"no_shift"`` (no block shifts its windows) or ``"no_bias"``
    (the relative-position bias left out; its table gets a zero
    gradient)."""
    from cluster_tools_tpu_torch.models import swin_unetr as S

    name = {"no_shift": "window_and_shift", "no_bias": "relative_bias"}[fault]
    orig = getattr(S, name)
    if fault == "no_shift":
        def fake(extent, window, shifted):
            return orig(extent, window, False)
    else:
        def fake(table, index, n):
            return orig(table, index, n) * 0.0
    setattr(S, name, fake)
    try:
        yield
    finally:
        setattr(S, name, orig)


def controls(ctx, seeds, n_controls):
    """Per seed, at the cell's own size: the program's three steps judged
    against the reference; for the first ``n_controls`` seeds also the
    control's (float8 e4m3 inputs), the program's with no shifted windows,
    without the bias and fed half of each batch, and the step returning
    the state it was given.  Yields ``{"seed", "side", <reading>:
    value}``."""
    import torch

    from portbench.refs import swin_unetr as R

    cfg, tr, dev = ctx.config, ctx.workload["traffic"], ctx.device
    B, crop = int(tr["batch"]), tuple(tr["crop"])
    micro = int(tr["micro_batch"])
    offsets = [tuple(o) for o in cfg["offsets"]]
    _, step, fresh = _setup(ctx)

    def program(p0, batches, frozen=False):
        state = fresh(p0)
        losses, g1 = [], None
        for i, (x, y) in enumerate(batches):
            new, loss = step(state, x, y)
            state = state if frozen else new
            losses.append(float(loss))
            if i == 0:
                g1 = _first_grad(state)
        return losses, g1, {k: v.clone() for k, v in state.params.items()}

    for i, seed in enumerate(seeds):
        xs, ys = _pool_driver().make_pool(int(tr["pool"]), crop, offsets,
                                          seed, dev)
        p0 = make_weights(seed, dev, cfg)
        first = np.random.default_rng(seed).permutation(
            int(tr["pool"]))[:3 * B].reshape(3, B)
        batches = [(xs[j], ys[j]) for j in
                   (torch.from_numpy(r).to(dev) for r in first)]
        prog = program(p0, batches)
        ref = R.train_steps(p0, batches, micro, cfg)
        yield {"seed": seed, "side": "program",
               **R.swin_compare(*prog[:2], p0, prog[2], *ref)}
        if i < n_controls:
            ctl = R.train_steps(p0, batches, micro, cfg, fp8=True)
            yield {"seed": seed, "side": "control",
                   **R.swin_compare(*ctl[:2], p0, ctl[2], *ref)}
            for fault in ("no_shift", "no_bias"):
                with planted(fault):
                    got = program(p0, batches)
                yield {"seed": seed, "side": fault,
                       **R.swin_compare(*got[:2], p0, got[2], *ref)}
            half = program(p0, [(x[:B // 2], y[:B // 2])
                                for x, y in batches])
            yield {"seed": seed, "side": "half_batch",
                   **R.swin_compare(*half[:2], p0, half[2], *ref)}
            # every step returns the state it was given
            still = program(p0, batches, frozen=True)
            yield {"seed": seed, "side": "state_unchanged",
                   **R.swin_compare(*still[:2], p0, still[2], *ref)}
        del xs, ys, batches
        if dev == "cuda":
            torch.cuda.empty_cache()


def _traced(ctx, step, state, batch, B, crop):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from cluster_tools_tpu_torch.core import telemetry

    from portbench.reduce import Trace, device_ops, marker_offset
    from portbench.refs.swin_cost import instnorm_step_bytes, swin_step_flop

    n = int(ctx.workload["traffic"]["trace_steps"])
    acts = [ProfilerActivity.CPU]
    if ctx.device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    telemetry.reset()
    telemetry.configure(enabled=True, ring_size=1 << 20)
    try:
        with profile(activities=acts) as prof:
            tp0 = time.perf_counter()
            with record_function("portbench.window"):
                for i in range(3, 3 + n):
                    state, _ = step(state, *batch(i))
                if ctx.device == "cuda":
                    torch.cuda.synchronize()
            tp1 = time.perf_counter()
        spans = telemetry.spans_snapshot()
    finally:
        telemetry.reset()
    ops = device_ops(prof)
    w0 = marker_offset(prof, "portbench.window") or 0.0
    window = tp1 - tp0
    ops = [(nm, a - w0, b - w0) for nm, a, b in ops
           if b - w0 > 0 and a - w0 < window]
    cfg = ctx.config
    return Trace(cell=ctx.workload, config=cfg, window_s=window,
                 device_ops=ops,
                 spans=[(s.name, s.cat, s.t0 - tp0, s.t1 - tp0)
                        for s in spans],
                 info={"steps": n, "step_flop": swin_step_flop(B, crop, cfg),
                       "norm_bytes": instnorm_step_bytes(B, crop, cfg)})
