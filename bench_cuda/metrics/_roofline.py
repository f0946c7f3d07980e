"""A port kernel's share of its roofline in the traced slice."""

from __future__ import annotations


def share(ctx: dict, kernel: str):
    """100 x (least time of the kernel's launches) / (their traced time).

    The least time of a launch is the larger of its operations at the bf16
    peak and its bytes at the memory's peak (``peaks.py``), from the work
    that the builder counts for one forward (``kernel_work``). None where
    the slice holds no launch of the kernel, the card has no peaks in the
    table, or the launches are not whole forwards."""
    from bench_cuda.peaks import bound_s

    tr, peaks = ctx.get("trace"), ctx.get("peaks")
    if not tr or not peaks or ctx.get("kind") != "offline":
        return None
    got = tr["kernels"].get(kernel)
    work = ctx["builder"].kernel_work(ctx["cfg"], ctx["batch"]).get(kernel)
    if not got or not got["launches"] or not work or got["seconds"] <= 0:
        return None
    if got["launches"] % len(work):
        return None
    least = sum(bound_s(nbytes, ops, peaks["bf16"], peaks)
                for ops, nbytes in work)
    return 100.0 * least * (got["launches"] // len(work)) / got["seconds"]
