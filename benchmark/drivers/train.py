"""GAN train steps through `train.step.make_train_step`, back to back.

Set-up builds one train state (`train.state.create_train_state`, its
weights replaced by the seed's through `load_state_dict`), makes a pool
of batches on the device from the seed, and drives the state through
its first three steps on three different batches with the window's own
step call and feed; those steps are the warm-up. The window then cycles
the pool. The rate is the samples of the steps the window ran over the
window, synchronised at its end.

`correct`: after the window, with the program's state freed, the
reference runs the same three steps from the same weights and batches.
Compared: each step's G and D losses (relative), the first gradient of
every leaf as Adam holds it after step 1 (its first moment over
1 - beta1), and every leaf's change over the three steps, saved before
step 4; norms by the worst leaf, each gap over the larger of the
reference leaf's norm and the median leaf's. Leaves whose reference
gradient is under a thousandth of the median leaf's (biases that
instance norms cancel) move under Adam by rounding alone and are left
out of the change.

The window's own first step is checked too, so that a step that takes
another path once warm is seen: the program's state (parameters and
both Adam moments) is copied on the device just before the window and
again after its first step, and the reference runs that step from the
first copy on the same batch. Compared as above, with the `.window`
suffix: the step's losses, its gradient (from the two first moments:
(m1 - beta1 m0) / (1 - beta1)) and its change.
"""

from __future__ import annotations

import json
import math
import sys
import time
import traceback

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import common, flops, traffic, weights
from benchmark.reference import model as ref
from benchmark.trace import Stretch

CHECK_STEPS = 3


def make_batches(ctx) -> list:
    tr = ctx.cell["traffic"]
    return [traffic.train_batch(common.rng(ctx.seed, 400 + i), ctx.config,
                                tr["batch"], tr["labels"], tr["radius"],
                                ctx.device) for i in range(tr["pool"])]


def build_program(ctx, w: dict):
    """The train state and its step, with the seed's weights."""
    from wacv23_tsnet_tpu_torch.ops import cuda_build
    from wacv23_tsnet_tpu_torch.train import state as state_mod
    from wacv23_tsnet_tpu_torch.train import step as step_mod
    cfg = common.port_config(ctx.config, ctx.cell["tier"])
    if ctx.device.type == "cuda":
        cuda_build.build_all(tuple(ctx.cell["kernels"]))
    st = state_mod.create_train_state(cfg, device=ctx.device)
    st.mods.load_state_dict({k: v for k, v in w.items()
                             if not k.startswith("vgg.")})
    st.vgg.load_state_dict({k[4:]: v for k, v in w.items()
                            if k.startswith("vgg.")})
    tr = ctx.cell["traffic"]
    marks = [] if ctx.trace else None

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    step = step_mod.make_train_step(
        st, lambda_dec=tr["lambda_dec"], d_lr_factor=tr["d_lr_factor"],
        use_kernels=True,
        mark=mark if marks is not None and ctx.device.type == "cuda" else None)
    return st, step, marks


def totals(m: dict) -> dict:
    """A step's objectives from its metrics: the discriminators' (read
    before any update), the generator's terms that no discriminator reads
    (VGG, gradient, warp, align), and its adversarial terms, which read
    the discriminators after their first Adam update (about lr times
    each gradient's sign, so a sign that rounding flips moves them)."""
    return {"loss_d": m["D"] + m.get("DF", 0.0),
            "loss_g": (m["G_VGG"] + m["grad_G"] + m["warp"]
                       + m.get("align", 0.0) + m.get("GF_VGG", 0.0)),
            "loss_adv": (m["G_GAN"] + m["G_FML"] + m.get("GF_GAN", 0.0)
                         + m.get("GF_FML", 0.0))}


def optimizer_state(st) -> dict:
    """name -> (parameter, its Adam state dict), over both optimizers."""
    params = dict(st.mods.named_parameters())
    opt_of = {}
    for opt in (st.gen_opt, st.disc_opt):
        for group in opt.param_groups:
            for p in group["params"]:
                opt_of[p] = opt
    return {k: (p, opt_of[p].state[p]) for k, p in params.items()}


def snapshot(st, moments: bool = True) -> dict:
    """name -> (parameter, first moment[, second moment, step count]),
    copied on the device (queued behind the steps, no wait)."""
    out = {}
    for k, (p, s) in optimizer_state(st).items():
        out[k] = (p.detach().clone(), s["exp_avg"].detach().clone())
        if moments:
            out[k] += (s["exp_avg_sq"].detach().clone(), int(s["step"]))
    return out


def program_first_steps(st, step, batches, lr) -> dict:
    """The first three steps, with what the check needs saved."""
    state = optimizer_state(st)
    losses, grads = [], {}
    for i in range(CHECK_STEPS):
        _, metrics, _ = step(st, batches[i], lr)
        losses.append(totals({k: float(v) for k, v in metrics.items()}))
        if i == 0:
            b1 = st.gen_opt.param_groups[0]["betas"][0]
            grads = {k: s["exp_avg"].detach() / (1 - b1)
                     for k, (_, s) in state.items()}
    after = {k: p.detach().clone() for k, (p, _) in state.items()}
    return {"losses": losses, "grads": grads, "params": after}


def program_window_step(before: dict, after: dict, metrics: dict,
                        b1: float) -> dict:
    """The window's first step from the copies taken around it."""
    return {"losses": [totals({k: float(v) for k, v in metrics.items()})],
            "grads": {k: (after[k][1] - b1 * before[k][1]) / (1 - b1)
                      for k in before},
            "params": {k: after[k][0] for k in before}}


def reference_steps(ctx, p: dict, adam: dict, batches, lr, prec) -> dict:
    """The reference's steps on `batches` from parameters `p` and Adam
    state `adam` (both updated in place): each step's objectives, the
    first step's gradients, and the parameters after the last."""
    tr = ctx.cell["traffic"]
    losses, grads = [], {}
    with ref.tf32(prec.tf32):
        for i, batch in enumerate(batches):
            m, g = ref.train_step(p, adam, ctx.config, batch, lr,
                                  tr["lambda_dec"], tr["d_lr_factor"])
            losses.append(totals(m))
            if i == 0:
                grads = g
    return {"losses": losses, "grads": grads,
            "params": {k: v.clone() for k, v in p.items()
                       if not k.startswith("vgg.")}}


def reference_first_steps(ctx, w: dict, batches, lr, prec,
                          adam: dict | None = None) -> dict:
    p = {k: v.clone() for k, v in w.items()}
    return reference_steps(ctx, p, {} if adam is None else adam,
                           batches[:CHECK_STEPS], lr, prec)


def reference_window_step(ctx, w: dict, before: dict, batch, lr,
                          prec) -> dict:
    """The window's first step, from the program's state before it."""
    p = {k: v.clone() for k, v in w.items() if k.startswith("vgg.")}
    p.update({k: v[0].clone() for k, v in before.items()})
    adam = {k: (v[1].clone(), v[2].clone(), v[3]) for k, v in before.items()}
    return reference_steps(ctx, p, adam, [batch], lr, prec)


def gaps(prog: dict, want: dict, base: dict, suffix: str = "") -> dict:
    """The numbers of a side against the reference: each step's worst
    relative loss gap (G and D objectives), and the per-leaf norm gaps of
    the first gradient and of the change from `base` (the parameters
    before the steps), by the worst leaf and by the median leaf. The
    cell's `limits` say which of them are compared. With `suffix` (one
    step from a given state) the loss gap is `loss_gap<suffix>`."""
    out = {}
    for i, (a, b) in enumerate(zip(prog["losses"], want["losses"])):
        gap = {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in b}
        name = f"loss_gap{suffix}" if suffix else f"loss_gap.step{i + 1}"
        out[name] = max(gap["loss_d"], gap["loss_g"])
        out[name + ".adv"] = gap["loss_adv"]
    g = common.norm_gaps(prog["grads"], want["grads"])
    live = common.live_leaves(want["grads"])
    d_prog = {k: prog["params"][k] - base[k] for k in want["params"]}
    d_want = {k: want["params"][k] - base[k] for k in want["params"]}
    c = common.norm_gaps(d_prog, d_want, keep=live)
    out["grad_norm_gap" + suffix], g_leaf = common.worst(g)
    out["change_norm_gap" + suffix], c_leaf = common.worst(c)
    out["grad_norm_gap.median" + suffix] = float(np.median(list(g.values())))
    out["change_norm_gap.median" + suffix] = float(
        np.median(list(c.values())))
    print(f"worst leaves{suffix}: gradient {g_leaf}, change {c_leaf}; "
          f"{len(want['params']) - len(live & set(want['params']))} leaves "
          "left out of the change", file=sys.stderr)
    return out


def control_readings(ctx, spec: dict | None = None,
                     half_batch: bool = False) -> dict:
    """The numbers of the reference in the program's place, computed at
    `spec`'s precision (the cell's `control` by default) or, with
    `half_batch`, on the first half of every batch: over the first three
    steps from the seed's weights, and over one step (the `.window`
    numbers) from the reference's state after them, on the batch the
    window's first step takes."""
    lr = ctx.cell["traffic"]["lr"]
    ref_prec = common.precision(ctx.cell["reference"])
    w = weights.make(ctx.config, ctx.seed, ctx.device, train=True)
    batches = make_batches(ctx)
    adam: dict = {}
    want = reference_first_steps(ctx, w, batches, lr, ref_prec, adam)
    start = dict(w, **want["params"])
    window = batches[CHECK_STEPS % len(batches)]
    if half_batch:
        batches = [{k: v[:v.shape[0] // 2] for k, v in b.items()}
                   for b in batches]
        prec = ref_prec
    else:
        prec = common.precision(spec or ctx.cell["control"])
    got = reference_first_steps(ctx, w, batches, lr, prec)
    out = gaps(got, want, w)

    def one(batch, prec):
        a = {k: (m.clone(), v.clone(), t) for k, (m, v, t) in adam.items()}
        p = {k: v.clone() for k, v in start.items()}
        return reference_steps(ctx, p, a, [batch], lr, prec)
    got_w = one(batches[CHECK_STEPS % len(batches)], prec)
    out.update(gaps(got_w, one(window, ref_prec), want["params"],
                    ".window"))
    return out


def run(ctx) -> dict:
    from wacv23_tsnet_tpu_torch.ops import cuda_build
    tr, dev = ctx.cell["traffic"], ctx.device
    lr = tr["lr"]
    w = weights.make(ctx.config, ctx.seed, dev, train=True)
    st, step, marks = build_program(ctx, w)
    batches = make_batches(ctx)
    first = program_first_steps(st, step, batches, lr)
    before = snapshot(st)
    b1 = st.gen_opt.param_groups[0]["betas"][0]
    common.sync(dev)
    if marks is not None:
        marks.clear()

    stretch = Stretch(ctx.trace)
    steps = failed = 0
    after = window_metrics = None
    launches0 = dict(cuda_build.LAUNCHES)
    launches = None
    stretch.start()          # the profiler's own start stays outside the window
    t_start = time.perf_counter()
    while True:
        i = CHECK_STEPS + steps
        steps += 1
        try:
            with record_function("bench.step"):
                _, metrics, _ = step(st, batches[i % len(batches)], lr)
            if steps == 1:
                after, window_metrics = snapshot(st, moments=False), metrics
        except Exception:
            failed += 1
            traceback.print_exc(file=sys.stderr)
        if launches is None and steps >= tr["traced_steps"]:
            stretch.stop()
            launches = {n: v - launches0[n]
                        for n, v in cuda_build.LAUNCHES.items()}
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    common.sync(dev)
    window_s = time.perf_counter() - t_start
    stretch.stop()
    if launches is None:
        launches = {n: v - launches0[n] for n, v in cuda_build.LAUNCHES.items()}
    peak = common.memory_peak(dev)
    window_prog = None
    if after is not None:
        window_prog = program_window_step(before, after, window_metrics, b1)
    del after, window_metrics
    digest = stretch.digest()
    stage_ms = []
    if marks:
        at = {}
        for name, ev in marks:
            if name == "d_opt":
                at = {"d_opt": ev}
            elif name == "g_loss_backward" and "d_opt" in at:
                stage_ms.append(at["d_opt"].elapsed_time(ev))
    del st, step, marks
    common.free(dev)

    prec = common.precision(ctx.cell["reference"])
    want = reference_first_steps(ctx, w, batches, lr, prec)
    got = gaps(first, want, w)
    if window_prog is not None:
        want = reference_window_step(ctx, w, before, batches[
            CHECK_STEPS % len(batches)], lr, prec)
        got.update(gaps(window_prog, want,
                        {k: v[0] for k, v in before.items()}, ".window"))
    del before
    limits = ctx.cell["limits"]
    print("readings: " + json.dumps(got), file=sys.stderr)
    cfg = ctx.config
    fs = cfg["image_size"] // 2 ** cfg["n_downsampling"]
    return {
        "attempted": steps, "failed": failed,
        "e2e": {"train_samples_per_s": (steps - failed) * tr["batch"]
                / window_s,
                "setup_s": t_start - ctx.t0},
        "checks": [(n, got.get(n, math.nan), limits[n]) for n in limits],
        "readings": got,
        "memory_peak_bytes": peak,
        "window_s": window_s,
        "model_flops": (steps - failed) * flops.train_step_flops(
            cfg, tr["batch"]),
        "trace": digest, "launches": launches, "stage_ms": stage_ms,
        "train_shape": {"groups": tr["batch"], "sources": cfg["n_source"],
                        "t": fs * fs,
                        "c": cfg["ngf"] * 2 ** cfg["n_downsampling"]},
    }
