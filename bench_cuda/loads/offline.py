"""Load kind ``offline``: a closed loop of full batches through the
program's offline forward, as ``Classifier`` and ``FamilyClassifier`` run
it.

Traffic parameters: ``batch`` (rows a step) and ``pool_batches`` (distinct
batches, made from the seed on the device and cycled). Each step's
probabilities go to the host as ``Classifier._probs`` sends them (``.float()``
on the device, then to host memory), but through a ring of pinned buffers
with a copy that does not block: the host dispatches up to ``AHEAD_S``
seconds of steps ahead of the oldest one it waits for, so that the card
stays fed while the host stands still for a moment.

End-to-end: ``images_per_s`` = images of every step dispatched in the window
/ the window. The window closes when ``--seconds`` are up: nothing more is
sent, every step sent has reached the host, and only then is the clock
read. ``device_mb`` = the device's peak allocation through set-up and the
window. Checked: the top five of every row of a seeded sample of steps (and
of the last one) against the reference on the same pool batch. With
``--trace 1`` the profiler covers one slice in the middle of the window,
which starts and ends with the device drained.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_cuda import harness as H
from bench_cuda import trace as T

SAMPLED_STEPS = 8
AHEAD_S = 4.0     # seconds of steps dispatched ahead of the one waited for
MAX_AHEAD = 512   # steps: the ring's pinned buffers, at most


def run(ctx: dict) -> dict:
    cfg, tr, b = ctx["cfg"], ctx["traffic"], ctx["builder"]
    dev, seconds = ctx["device"], ctx["seconds"]
    batch, n_pool = int(tr["batch"]), int(tr["pool_batches"])
    gen = H.generator(ctx["seed"], dev)
    weights = b.make_weights(cfg, gen, dev)
    pool = H.device_pool(gen, n_pool, batch, b.input_shape(cfg), dev)
    H.mark(ctx, "weights and inputs")
    fwd = getattr(b, ctx.get("entry", "offline_forward"))(
        cfg, weights, batch, dev)
    H.mark(ctx, "prepare")

    # warm-up: every pool batch twice (the first launch builds the
    # kernels), the second round timed to place the sample
    for j in range(n_pool):
        fwd(pool[j]).float().cpu().numpy()
    H.mark(ctx, "first forwards")
    t0 = H.now()
    for j in range(n_pool):
        n_cls = fwd(pool[j]).float().cpu().numpy().shape[-1]
    step_s = (H.now() - t0) / n_pool
    rng = np.random.default_rng([ctx["seed"], 3])
    span = max(SAMPLED_STEPS, int(seconds / max(step_s, 1e-6) * 0.5))
    sample = set(rng.choice(span, SAMPLED_STEPS, replace=False).tolist())
    if ctx["trace"]:
        T.warm_profiler(dev)
    slice_s = min(1.0, 0.2 * seconds)
    sl = T.Slice(dev) if ctx["trace"] else None

    # the ring: step n's probabilities land in slot n % depth; before slot
    # k takes a new step, the host waits for the one it held
    depth = max(2, min(MAX_AHEAD, math.ceil(AHEAD_S / max(step_s, 1e-6))))
    ring = torch.empty((depth, batch, n_cls), dtype=torch.float32,
                       pin_memory=dev.type == "cuda")
    done = [None] * depth
    held = [-1] * depth
    kept = {}

    def retire(k: int) -> None:
        """Wait until slot k's step has reached the host; keep it if it is
        sampled."""
        if done[k] is not None:
            done[k].synchronize()
            done[k] = None
        if held[k] in sample:
            kept[held[k]] = (held[k] % n_pool, ring[k].numpy().copy())

    def drain() -> None:
        for k in range(depth):
            retire(k)
            held[k] = -1

    H.sync(dev)
    t_open = H.now()
    setup_s = t_open - ctx["t_start"]
    steps = 0
    sl_steps = sl_t0 = sl_t1 = None
    c0 = c1 = None
    while True:
        k = steps % depth
        retire(k)
        probs = fwd(pool[steps % n_pool]).float()
        ring[k].copy_(probs, non_blocking=True)
        if dev.type == "cuda":
            done[k] = torch.cuda.Event()
            done[k].record()
        held[k] = steps
        del probs
        steps += 1
        t = H.now()
        if sl is not None:
            if sl_t0 is None and t - t_open >= 0.4 * seconds:
                sl.start()
                c0, sl_t0, sl_steps = H.launches(), H.now(), steps
            elif sl_t0 is not None and sl_t1 is None and t - sl_t0 >= slice_s:
                c1 = H.launches()
                sl.stop()
                sl_t1, sl_steps = H.now(), steps - sl_steps
                t = H.now()
        if t - t_open >= seconds and (sl is None or sl_t1 is not None):
            break
    # send nothing more; the window closes once every step sent is home
    sample.add(steps - 1)
    drain()
    t_close = H.now()
    window = t_close - t_open
    peak = H.process_peak(dev)

    out = {
        "attempted": steps * batch, "failed": 0,
        "memory_peak_bytes": peak,
        "e2e": {"images_per_s": steps * batch / window,
                "device_mb": peak / H.MIB, "setup_s": setup_s},
        "extra": {"steps": steps, "measured_s": window},
    }
    if sl is not None:
        untraced_s = window - (sl_t1 - sl_t0)
        out["trace"] = T.summarize(sl, ctx["kernel_table"],
                                   H.counted(c0, c1))
        out["layer"] = {
            "kind": "offline", "batch": batch,
            "images_per_s": (steps - sl_steps) * batch / untraced_s}
    else:
        out["layer"] = {}

    ids, probs, image = [], [], []
    for step in sorted(kept):
        j, p = kept[step]
        i5, p5 = H.top5(p)
        ids.append(i5)
        probs.append(p5)
        image.append(j * batch + np.arange(batch))
    out["answers"] = {"ids": np.concatenate(ids),
                      "probs": np.concatenate(probs),
                      "image": np.concatenate(image)}
    del fwd
    H.free_program(dev)
    out["weights"] = weights
    out["ref_images"] = pool.reshape(n_pool * batch, *pool.shape[2:])
    return out
