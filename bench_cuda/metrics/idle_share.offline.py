"""idle_share.offline: the share of an offline slice in which no kernel,
copy or set ran on the device, in %: 100 x (1 - union of the device's
activity intervals / the slice). None outside an offline cell or where the
slice ran nothing on the device."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "offline" or not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
