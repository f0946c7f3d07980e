"""mfu.offline: the offline step's share of the card's bf16 peak, in %:
FLOPs of one image (counted from the layer shapes) x images/s over the
untraced part of the window / the data-sheet peak. None outside an offline
cell or on a card with no peaks in the table."""


def read(ctx):
    peaks = ctx.get("peaks")
    if ctx.get("kind") != "offline" or not peaks:
        return None
    flops = ctx["builder"].flops_per_image(ctx["cfg"])
    return 100.0 * flops * ctx["images_per_s"] / peaks["bf16"]
